"""Hand-written CUDA kernels (``csrc/``), their plain PyTorch versions
(``ref``) and the dispatchers that route between them (``ops``).

``fwht`` and ``circulant_project`` are re-exported from ``ops``, as the
reference does; the name ``fwht`` then shadows the CUDA wrapper module
of the same name (reach it with ``importlib.import_module``)."""
from . import ops, ref
from .ops import circulant_project, fwht

__all__ = ["ops", "ref", "circulant_project", "fwht"]
