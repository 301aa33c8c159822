"""Wrapper of the CUDA Walsh-Hadamard transform (``csrc/fwht.cu``):
(B, n) -> (B, n) in Sylvester order, scaled by 1/sqrt(n) when
normalized, f32 arithmetic and one cast to the input's dtype.

Counterpart of ``repro.kernels.fwht.fwht_pallas``. CUDA tensors only;
``kernels.ops.fwht`` routes CPU tensors, and an n above ``MAX_N``, to
the plain version (``kernels.ref.fwht_ref``). ``fwht_cuda.launches``
counts launches.
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch

from repro_torch.core import transforms

from . import build

MAX_N = 16384        # kron_factors a, b <= 128: the reference kernel's range

_P, _L, _I, _F = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, \
    ctypes.c_float


@functools.lru_cache(maxsize=None)
def _lib():
    lib = build.load("fwht")
    for fn in (lib.fwht_f32, lib.fwht_bf16):
        fn.argtypes = [_P, _P, _L, _I, _F, _P]
        fn.restype = ctypes.c_int
    return lib


def fwht_cuda(x: torch.Tensor, normalized: bool = True) -> torch.Tensor:
    """x: contiguous (B, n) float32 or bfloat16 on the card, n a power of
    two <= MAX_N -> (B, n) in x's dtype. Launches on the current stream."""
    if not x.is_cuda:
        raise ValueError(f"fwht kernel needs a CUDA tensor, got x on "
                         f"{x.device}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"fwht kernel takes float32 or bfloat16, got "
                         f"{x.dtype}")
    if x.dim() != 2 or not x.is_contiguous():
        raise ValueError(f"fwht kernel: x must be a contiguous (B, n) "
                         f"tensor, got shape {tuple(x.shape)}")
    bsz, n = x.shape
    if not transforms.is_pow2(n) or n > MAX_N:
        raise ValueError(f"fwht kernel needs n a power of two <= {MAX_N}, "
                         f"got {n}")
    out = torch.empty_like(x)
    if bsz == 0:
        return out
    lib = _lib()
    fn = lib.fwht_f32 if x.dtype == torch.float32 else lib.fwht_bf16
    scale = 1.0 / math.sqrt(n) if normalized else 1.0
    rc = fn(x.data_ptr(), out.data_ptr(), bsz, n, scale,
            torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"fwht kernel launch failed: cudaError {rc}")
    fwht_cuda.launches += 1
    return out


fwht_cuda.launches = 0
