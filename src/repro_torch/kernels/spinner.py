"""Wrappers of the CUDA spinner kernels (``csrc/spinner.cu``):
f(y_scale · A · D1 H D0 · x) · out_scale in one launch, A regenerated
on chip from its O(n) generator (``spinner_project_cuda``) or, with
the generator and both HD diagonals, from one seed per group
(``spinner_project_seeded_cuda``).

Counterparts of ``repro.kernels.spinner.spinner_project_pallas`` and
``spinner_project_seeded_pallas``. The wrappers take CUDA tensors only
and raise on anything the kernels do not take;
``kernels.ops.spinner_project(_seeded)`` decides between them and the
plain versions (``kernels.ref.spinner_project(_seeded)_ref``).
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
_SEEDED_ARGTYPES = [_P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _F, _F, _F, _P]


@functools.lru_cache(maxsize=None)
def _lib():
    lib = build.load("spinner")
    for fn in (lib.spinner_project_f32, lib.spinner_project_bf16):
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
    for fn in (lib.spinner_project_seeded_f32,
               lib.spinner_project_seeded_bf16):
        fn.argtypes = _SEEDED_ARGTYPES
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


def _check_x(kind: str, x: torch.Tensor, m: int, epilogue: str) -> None:
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
    n = x.shape[-1]
    if not 0 < n <= MAX_N or m <= 0:
        raise ValueError(f"spinner kernel needs 0 < n <= {MAX_N} and m > 0, "
                         f"got n={n}, m={m}")


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
    _check_x(kind, x, m, epilogue)
    gsz, bsz, n = x.shape
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


def spinner_project_seeded_cuda(kind: str, seeds: torch.Tensor,
                                x: torch.Tensor, m: int, use_hd: bool = True,
                                epilogue: str = "identity",
                                y_scale: float = 1.0,
                                out_scale: float = 1.0) -> torch.Tensor:
    """x: (G, B, n) -> (G, B, m), or (G, B, 2m) = [cos | sin] for cos_sin,
    with g, d0 and d1 regenerated in the kernel from ``seeds``: (G,) int64
    on x's device, each holding a uint32 seed (``kernels.seedgen``).
    float32 or bfloat16 x; f32 math, one cast on write. Launches on the
    current stream; ``spinner_project_seeded_cuda.launches`` counts the
    launches."""
    _check_x(kind, x, m, epilogue)
    gsz, bsz, n = x.shape
    if seeds.device != x.device or seeds.dtype != torch.int64 \
            or tuple(seeds.shape) != (gsz,) or not seeds.is_contiguous():
        raise ValueError(f"seeded spinner kernel: seeds must be a contiguous "
                         f"({gsz},) int64 tensor on {x.device}, got "
                         f"{tuple(seeds.shape)} {seeds.dtype} on "
                         f"{seeds.device}")
    if use_hd and not transforms.is_pow2(n):
        raise ValueError(f"seeded spinner kernel: HD needs power-of-two n, "
                         f"got {n}")
    width = 2 * m if epilogue == "cos_sin" else m
    out = torch.empty((gsz, bsz, width), dtype=x.dtype, device=x.device)
    if gsz == 0 or bsz == 0:
        return out
    lib = _lib()
    fn = (lib.spinner_project_seeded_f32 if x.dtype == torch.float32
          else lib.spinner_project_seeded_bf16)
    rc = fn(x.data_ptr(), seeds.data_ptr(), out.data_ptr(), gsz, bsz, n, m,
            KERNEL_KINDS.index(kind), EPILOGUES.index(epilogue),
            int(use_hd), 1.0 / math.sqrt(n), float(y_scale),
            float(out_scale), torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"seeded spinner kernel launch failed: "
                           f"cudaError {rc}")
    spinner_project_seeded_cuda.launches += 1
    return out


spinner_project_seeded_cuda.launches = 0
