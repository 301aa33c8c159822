"""Hand-written CUDA kernels (``csrc/``), their plain PyTorch versions
(``ref``) and the dispatchers that route between them (``ops``).

The public ops are re-exported from ``ops``, as the reference does; the
names ``fwht``, ``paged_gather`` and ``srf_decode`` then shadow the CUDA
wrapper modules of the same names (reach those with
``importlib.import_module("repro_torch.kernels.<name>")``)."""
from . import ops, ref
from .ops import (circulant_project, fwht, paged_gather, spinner_plan,
                  spinner_project, srf_decode)

__all__ = ["ops", "ref", "circulant_project", "fwht", "paged_gather",
           "spinner_plan", "spinner_project", "srf_decode"]
