"""Wrapper of the CUDA spinner kernel (``csrc/spinner.cu``):
f(y_scale · A · D1 H D0 · x) · out_scale in one launch, A regenerated
from its O(n) generator on chip.

Counterpart of ``repro.kernels.spinner.spinner_project_pallas``. The
wrapper takes CUDA tensors only and raises on anything the kernel does
not take; ``kernels.ops.spinner_project`` decides between it and the
plain version (``kernels.ref.spinner_project_ref``).
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional

import torch

from repro_torch.core import transforms

from . import build

EPILOGUES = ("identity", "relu", "heaviside", "sign", "exp", "cos_sin")
KERNEL_KINDS = ("circulant", "skew_circulant", "toeplitz", "hankel",
                "unstructured")
MAX_N = 8192

_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, \
    ctypes.c_float
_ARGTYPES = [_P, _P, _P, _P, _P, _I, _I, _I, _I, _L, _I, _I, _I, _F, _F, _F,
             _P]


@functools.lru_cache(maxsize=None)
def _lib():
    lib = build.load("spinner")
    for fn in (lib.spinner_project_f32, lib.spinner_project_bf16):
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
    return lib


def _gen_shape(kind: str, gsz: int, n: int, m: int):
    if kind in ("circulant", "skew_circulant"):
        return (gsz, -(-m // n), n)
    if kind in ("toeplitz", "hankel"):
        return (gsz, n + m - 1)
    return (gsz, m, n)


def _check(name: str, t: torch.Tensor, x: torch.Tensor, shape) -> None:
    if t.device != x.device or t.dtype != x.dtype:
        raise ValueError(f"spinner kernel: {name} must be {x.dtype} on "
                         f"{x.device}, got {t.dtype} on {t.device}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"spinner kernel: {name} must have shape "
                         f"{tuple(shape)}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"spinner kernel: {name} must be contiguous")


def spinner_project_cuda(kind: str, g: torch.Tensor, x: torch.Tensor, m: int,
                         d0: Optional[torch.Tensor] = None,
                         d1: Optional[torch.Tensor] = None,
                         epilogue: str = "identity", y_scale: float = 1.0,
                         out_scale: float = 1.0) -> torch.Tensor:
    """x: (G, B, n) -> (G, B, m), or (G, B, 2m) = [cos | sin] for cos_sin.

    g: (G, nb, n) for circulant / skew_circulant, (G, n+m-1) for toeplitz
    / hankel, (G, m, n) dense; d0/d1: (G, n) signs, both or neither.
    x, g, d0 and d1 share one dtype, float32 or bfloat16; the math is f32
    and the output is cast to that dtype once. Launches on the current
    stream; ``spinner_project_cuda.launches`` counts the launches.
    """
    if kind not in KERNEL_KINDS:
        raise ValueError(f"spinner kernel: kind {kind!r} not in "
                         f"{KERNEL_KINDS}")
    if epilogue not in EPILOGUES:
        raise ValueError(f"spinner kernel: epilogue {epilogue!r} not in "
                         f"{EPILOGUES}")
    if not x.is_cuda:
        raise ValueError(f"spinner kernel needs CUDA tensors, got x on "
                         f"{x.device}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"spinner kernel takes float32 or bfloat16, got "
                         f"{x.dtype}")
    if x.dim() != 3 or not x.is_contiguous():
        raise ValueError(f"spinner kernel: x must be a contiguous (G, B, n) "
                         f"tensor, got shape {tuple(x.shape)}")
    gsz, bsz, n = x.shape
    if not 0 < n <= MAX_N or m <= 0:
        raise ValueError(f"spinner kernel needs 0 < n <= {MAX_N} and m > 0, "
                         f"got n={n}, m={m}")
    _check("g", g, x, _gen_shape(kind, gsz, n, m))
    use_hd = d0 is not None
    if use_hd != (d1 is not None):
        raise ValueError("spinner kernel: pass both d0 and d1, or neither")
    if use_hd:
        if not transforms.is_pow2(n):
            raise ValueError(f"spinner kernel: HD needs power-of-two n, "
                             f"got {n}")
        _check("d0", d0, x, (gsz, n))
        _check("d1", d1, x, (gsz, n))
    width = 2 * m if epilogue == "cos_sin" else m
    out = torch.empty((gsz, bsz, width), dtype=x.dtype, device=x.device)
    if gsz == 0 or bsz == 0:
        return out
    lib = _lib()
    fn = (lib.spinner_project_f32 if x.dtype == torch.float32
          else lib.spinner_project_bf16)
    rc = fn(x.data_ptr(), d0.data_ptr() if use_hd else None,
            d1.data_ptr() if use_hd else None, g.data_ptr(), out.data_ptr(),
            gsz, bsz, n, m, g.numel() // gsz, KERNEL_KINDS.index(kind),
            EPILOGUES.index(epilogue), int(use_hd), 1.0 / math.sqrt(n),
            float(y_scale), float(out_scale),
            torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"spinner kernel launch failed: cudaError {rc}")
    spinner_project_cuda.launches += 1
    return out


spinner_project_cuda.launches = 0
