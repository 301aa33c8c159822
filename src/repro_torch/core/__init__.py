"""The paper's core objects: Hadamard preconditioning, structured
Gaussian matrices, spinner pipelines, feature maps and SRF attention
(the ``spinner`` API: ``SpinnerBlock`` / ``SpinnerPipeline``;
``pmodel`` is the deprecated one-block shim)."""
from . import (coherence, estimators, features, pmodel, spinner,
               srf_attention, structured, transforms)
from .pmodel import PModelSpec
from .spinner import SpinnerBlock, SpinnerPipeline
from .srf_attention import SRFConfig

__all__ = [
    "coherence", "estimators", "features", "pmodel", "spinner",
    "srf_attention", "structured", "transforms",
    "PModelSpec", "SpinnerBlock", "SpinnerPipeline", "SRFConfig",
]
