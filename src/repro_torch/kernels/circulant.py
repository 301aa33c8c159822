"""Wrapper of the CUDA block-circulant projection (``csrc/circulant.cu``):

    y[b, i] = sum_j x[b, j] g[i // n, (j - i mod n) mod n],   out = f(y)

with f one of ``EPILOGUES`` (exp: exp(y - sq[b]); cos_sin: [cos y | sin
y], width 2m), f32 accumulation and one cast to x's dtype.

Counterpart of ``repro.kernels.circulant.circulant_project_pallas``, for
any m <= nb * n (the reference also asks m % min(block_m, m) == 0; the
kernel masks a ragged m instead). CUDA tensors only; ``kernels.ops``
routes CPU tensors to the plain version
(``kernels.ref.circulant_project_ref``). ``circulant_project_cuda.launches``
counts launches.

The kernel is the mainloop of ``csrc/window_mma.cuh`` (shared with the
spinner kernels) on 128 x 128 output tiles, A regenerated chunk by chunk:
:func:`b_tile` states, in plain PyTorch, the (BK, BN) operand it reads
for output columns i0.. and input columns j0.. (a Toeplitz window of the
generator, or the per-row rule for a tile that crosses a generator
block: ``kernels.window``), so the index rule is held to
``ref.circulant_matrix`` on the CPU.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from . import build, window
from .ref import CIRCULANT_EPILOGUES as EPILOGUES

_P, _I = ctypes.c_void_p, ctypes.c_int
BM = 128                # rows of x a block (csrc/circulant.cu)
BN, BK = window.BN, window.BK


def window_ok(n: int, i0: int) -> bool:
    """Whether output columns [i0, i0 + BN) lie in one generator block,
    so that the kernel reads their chunk of A as a Toeplitz window."""
    return window.layout("circulant", n, i0) == "window"


def b_tile(g: torch.Tensor, m: int, i0: int, j0: int) -> torch.Tensor:
    """The (BK, BN) operand the kernel reads for chunk j0 of output
    columns i0: [k, c] = A[i0 + c, j0 + k], by the kernel's rules. A
    window tile reads w[j0 + k - c + BN - 1], w the generator values from
    (-i0 mod n - (BN - 1)) mod n on (indices mod n: the doubled
    generator); its columns past m and rows past n are left as the window
    gives them (the kernel masks the output and zero-fills x). Any other
    tile takes A[i, j] = g[i // n, (j - i mod n) mod n], zero past m and
    n."""
    n = g.shape[1]
    return window.operand("circulant", window.dense_source(g, n, m), n, m,
                          i0, j0)


@functools.lru_cache(maxsize=None)
def _lib():
    lib = build.load("circulant")
    for fn in (lib.circulant_project_f32, lib.circulant_project_bf16):
        fn.argtypes = [_P, _P, _P, _P, _I, _I, _I, _I, _I, _P]
        fn.restype = ctypes.c_int
    return lib


def circulant_project_cuda(g: torch.Tensor, x: torch.Tensor, m: int,
                           epilogue: str = "identity",
                           sq: Optional[torch.Tensor] = None
                           ) -> torch.Tensor:
    """g: (nb, n) generators, x: (B, n), both contiguous float32 or both
    bfloat16 on the card; sq: (B,) for exp -> (B, m), or (B, 2m) for
    cos_sin, in x's dtype. Launches on the current stream."""
    if epilogue not in EPILOGUES:
        raise ValueError(f"circulant kernel: epilogue {epilogue!r} not in "
                         f"{EPILOGUES}")
    if not x.is_cuda or g.device != x.device:
        raise ValueError(f"circulant kernel needs CUDA tensors on one "
                         f"device, got x on {x.device}, g on {g.device}")
    if x.dtype not in (torch.float32, torch.bfloat16) or g.dtype != x.dtype:
        raise ValueError(f"circulant kernel takes float32 or bfloat16 x and "
                         f"g of one dtype, got {x.dtype} and {g.dtype}")
    if x.dim() != 2 or g.dim() != 2 or g.shape[1] != x.shape[1] \
            or not x.is_contiguous() or not g.is_contiguous():
        raise ValueError(f"circulant kernel: x must be a contiguous (B, n) "
                         f"and g a contiguous (nb, n) tensor, got "
                         f"{tuple(x.shape)} and {tuple(g.shape)}")
    bsz, n = x.shape
    nb = g.shape[0]
    if not 0 < m <= nb * n:
        raise ValueError(f"circulant kernel: generators cover {nb * n} rows, "
                         f"m={m}")
    if epilogue == "exp":
        if sq is None:
            raise ValueError("circulant kernel: exp needs sq")
        sq = sq.reshape(-1).float().contiguous()
        if sq.shape != (bsz,) or sq.device != x.device:
            raise ValueError(f"circulant kernel: sq must be ({bsz},) on "
                             f"{x.device}")
    width = 2 * m if epilogue == "cos_sin" else m
    out = torch.empty((bsz, width), dtype=x.dtype, device=x.device)
    if bsz == 0:
        return out
    lib = _lib()
    fn = (lib.circulant_project_f32 if x.dtype == torch.float32
          else lib.circulant_project_bf16)
    rc = fn(x.data_ptr(), g.data_ptr(),
            sq.data_ptr() if epilogue == "exp" else None, out.data_ptr(),
            bsz, n, nb, m, window.EPILOGUES.index(epilogue),
            torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"circulant kernel launch failed: cudaError {rc}")
    circulant_project_cuda.launches += 1
    return out


circulant_project_cuda.launches = 0
