"""Architecture configs (one file per assigned arch) + registry."""
from .base import ModelConfig, SRFAttnConfig
from . import registry
from .registry import ARCHS, get, reduced

__all__ = ["ModelConfig", "SRFAttnConfig", "registry", "ARCHS", "get",
           "reduced"]
