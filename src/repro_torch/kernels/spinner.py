"""Wrappers of the CUDA spinner kernels (``csrc/spinner.cu``):
f(y_scale · A · D1 H D0 · x) · out_scale on the tensor cores, A
regenerated on chip from its O(n) generator (``spinner_project_cuda``)
or, with the generator and both HD diagonals, from one seed per group
(``spinner_project_seeded_cuda``).

Counterparts of ``repro.kernels.spinner.spinner_project_pallas`` and
``spinner_project_seeded_pallas``. The wrappers take CUDA tensors only
and raise on anything the kernels do not take;
``kernels.ops.spinner_project(_seeded)`` decides between them and the
plain versions (``kernels.ref.spinner_project(_seeded)_ref``).

Both kernels run the mainloop of ``csrc/window_mma.cuh`` on the A operand
z = D1 H D0 x / sqrt(n). Up to n = ``window.RES_N`` (128) each block
computes z for its rows itself; above it a pre-pass in the same launch
sequence writes z (with HD) and 0.5 ||x||^2 (exp) once per row into
scratch this module allocates (:func:`scratch`). A call is one counted
launch of the kernel either way. :func:`b_tile` and
:func:`seeded_b_tile` state the B operand each block reads, in plain
PyTorch (``kernels.window``), so the index rules are held to
``structured.materialize`` and ``seedgen.grouped_params`` on the CPU.
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional, Tuple

import torch

from repro_torch.core import transforms

from . import build, window
from .window import EPILOGUES

KERNEL_KINDS = ("circulant", "skew_circulant", "toeplitz", "hankel",
                "unstructured")
MAX_N = 8192

_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, \
    ctypes.c_float
_ARGTYPES = [_P] * 7 + [_I] * 4 + [_L] + [_I] * 3 + [_F] * 3 + [_P]
_SEEDED_ARGTYPES = [_P] * 5 + [_I] * 7 + [_F] * 3 + [_P]


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


def scratch(n: int, use_hd: bool, epilogue: str, dtype=torch.float32
            ) -> Tuple[bool, bool]:
    """(z, sq): whether a launch at width n needs the pre-pass's float32
    outputs, z (G, B, n) = D1 H D0 x / sqrt(n) (or, bf16 x without HD, x
    itself: the mainloop's A operand is f32) and 0.5 ||x||^2 (G, B). The
    kernel takes the same rule from the shape: rows of n <= RES_N stay in
    the block."""
    big = n > window.RES_N
    return (big and (use_hd or dtype == torch.bfloat16),
            big and epilogue == "exp")


def _n_of(kind: str, g: torch.Tensor, m: int) -> int:
    if kind in ("toeplitz", "hankel"):
        return g.shape[-1] - m + 1
    return g.shape[-1]


def b_tile(kind: str, g: torch.Tensor, m: int, i0: int, j0: int
           ) -> torch.Tensor:
    """The (BK, BN) B operand a spinner block multiplies chunk j0 of output
    columns i0 by, [k, c] = A[i0 + c, j0 + k], read from one group's
    generator g ((nb, n), (n + m - 1,) or (m, n)) by the kernel's rules
    (``window.layout``: a Toeplitz or Hankel window, or a built tile)."""
    n = _n_of(kind, g, m)
    return window.operand(kind, window.dense_source(g, n, m), n, m, i0, j0)


def seeded_b_tile(kind: str, seed: int, n: int, m: int, i0: int, j0: int
                  ) -> torch.Tensor:
    """:func:`b_tile` as the seeded kernel builds it: from the values it
    draws once at ``window.seeded_positions`` (dense A: at each entry)."""
    return window.operand(kind, window.seeded_source(kind, seed, n, m, i0),
                          n, m, i0, j0)


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


def _scratch(x: torch.Tensor, use_hd: bool, epilogue: str):
    """The pre-pass outputs for x (G, B, n), or None where not needed;
    the caller holds them until the launches are queued (the allocator
    is stream-ordered)."""
    need_z, need_sq = scratch(x.shape[-1], use_hd, epilogue, x.dtype)
    z = torch.empty(x.shape, dtype=torch.float32,
                    device=x.device) if need_z else None
    sq = torch.empty(x.shape[:2], dtype=torch.float32,
                     device=x.device) if need_sq else None
    return z, sq


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def spinner_project_cuda(kind: str, g: torch.Tensor, x: torch.Tensor, m: int,
                         d0: Optional[torch.Tensor] = None,
                         d1: Optional[torch.Tensor] = None,
                         epilogue: str = "identity", y_scale: float = 1.0,
                         out_scale: float = 1.0) -> torch.Tensor:
    """x: (G, B, n) -> (G, B, m), or (G, B, 2m) = [cos | sin] for cos_sin.

    g: (G, nb, n) for circulant / skew_circulant, (G, n+m-1) for toeplitz
    / hankel, (G, m, n) dense; d0/d1: (G, n) signs, both or neither.
    x, g, d0 and d1 share one dtype, float32 or bfloat16: f32 on the
    tensor cores as 3xTF32, bf16 as bf16 products of z = hi + lo with f32
    accumulation; the output is cast to that dtype once. Launches on the current
    stream (at n > 128 the pre-pass, then the projection);
    ``spinner_project_cuda.launches`` counts the calls that launched.
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
    z, sq = _scratch(x, use_hd, epilogue)
    lib = _lib()
    fn = (lib.spinner_project_f32 if x.dtype == torch.float32
          else lib.spinner_project_bf16)
    rc = fn(x.data_ptr(), _ptr(d0), _ptr(d1), g.data_ptr(), _ptr(z),
            _ptr(sq), out.data_ptr(), gsz, bsz, n, m, g.numel() // gsz,
            KERNEL_KINDS.index(kind),
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
    float32 or bfloat16 x, as :func:`spinner_project_cuda`; the f32 output
    equals it on ``seedgen.grouped_params(seeds)`` bit for bit. Launches on
    the current stream; ``spinner_project_seeded_cuda.launches`` counts the
    calls that launched."""
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
    z, sq = _scratch(x, use_hd, epilogue)
    lib = _lib()
    fn = (lib.spinner_project_seeded_f32 if x.dtype == torch.float32
          else lib.spinner_project_seeded_bf16)
    rc = fn(x.data_ptr(), seeds.data_ptr(), _ptr(z), _ptr(sq),
            out.data_ptr(), gsz, bsz, n, m,
            KERNEL_KINDS.index(kind), EPILOGUES.index(epilogue),
            int(use_hd), 1.0 / math.sqrt(n), float(y_scale),
            float(out_scale), torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"seeded spinner kernel launch failed: "
                           f"cudaError {rc}")
    spinner_project_seeded_cuda.launches += 1
    return out


spinner_project_seeded_cuda.launches = 0
