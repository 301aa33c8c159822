"""Wrappers of the CUDA paged gathers (``csrc/paged_gather.cu``):

    out[r, j*P:(j+1)*P, :] = pool[clamp(tables[r, j], 0, N-1)]

from a (N, P, D) pool of any dtype, and the int8 variant that multiplies
each page row by its f32 scale and writes bf16 or f32.

Counterparts of ``repro.kernels.paged_gather.paged_gather_pallas`` and
``paged_gather_dequant_pallas``. CUDA tensors only; ``kernels.ops``
routes CPU tensors to the plain versions (``kernels.ref``). Each wrapper
counts its launches in ``.launches``.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import build

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
OUT_DTYPES = (torch.bfloat16, torch.float32)


@functools.lru_cache(maxsize=None)
def _lib():
    lib = build.load("paged_gather")
    lib.paged_gather.argtypes = [_P, _P, _I, _P, _L, _L, _L, _P]
    lib.paged_gather.restype = ctypes.c_int
    lib.paged_gather_dequant.argtypes = [_P, _P, _P, _I, _P, _I, _L, _L, _I,
                                         _I, _P]
    lib.paged_gather_dequant.restype = ctypes.c_int
    return lib


def _check(name: str, pool: torch.Tensor, tables: torch.Tensor) -> None:
    for what, t in (("pool", pool), ("tables", tables)):
        if not t.is_cuda or t.device != pool.device:
            raise ValueError(f"{name} kernel needs CUDA tensors on one "
                             f"device, got {what} on {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} kernel: {what} must be contiguous")
    if pool.dim() != 3 or tables.dim() != 2:
        raise ValueError(f"{name} kernel: pool must be (N, P, D) and tables "
                         f"(R, M), got {tuple(pool.shape)} and "
                         f"{tuple(tables.shape)}")
    if tables.dtype not in (torch.int32, torch.int64):
        raise ValueError(f"{name} kernel: tables must be int32 or int64, "
                         f"got {tables.dtype}")
    if pool.shape[0] == 0:
        raise ValueError(f"{name} kernel: the pool has no pages")


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def paged_gather_cuda(pool: torch.Tensor, tables: torch.Tensor
                      ) -> torch.Tensor:
    """pool (N, P, D), any dtype; tables (R, M) int32/int64 page ids ->
    (R, M*P, D) in pool's dtype. ``paged_gather_cuda.launches`` counts
    launches."""
    _check("paged_gather", pool, tables)
    n, p, d = pool.shape
    r, m = tables.shape
    out = torch.empty((r, m * p, d), dtype=pool.dtype, device=pool.device)
    if out.numel() == 0:
        return out
    rc = _lib().paged_gather(pool.data_ptr(), tables.data_ptr(),
                             int(tables.dtype == torch.int64),
                             out.data_ptr(), r * m, n,
                             p * d * pool.element_size(), _stream(pool))
    if rc != 0:
        raise RuntimeError(f"paged_gather kernel launch failed: "
                           f"cudaError {rc}")
    paged_gather_cuda.launches += 1
    return out


def paged_gather_dequant_cuda(pool: torch.Tensor, scales: torch.Tensor,
                              tables: torch.Tensor,
                              out_dtype=torch.float32) -> torch.Tensor:
    """pool (N, P, D) int8; scales (N, P, 1) float32 row scales; tables
    (R, M) int32/int64 -> (R, M*P, D) ``out_dtype`` (bf16 or f32).
    ``paged_gather_dequant_cuda.launches`` counts launches."""
    _check("paged_gather_dequant", pool, tables)
    n, p, d = pool.shape
    if pool.dtype != torch.int8:
        raise ValueError(f"paged_gather_dequant kernel takes an int8 pool, "
                         f"got {pool.dtype}")
    if (scales.dtype != torch.float32 or tuple(scales.shape) != (n, p, 1)
            or not scales.is_contiguous() or scales.device != pool.device):
        raise ValueError(f"paged_gather_dequant kernel: scales must be a "
                         f"contiguous float32 ({n}, {p}, 1) tensor on "
                         f"{pool.device}, got {scales.dtype} "
                         f"{tuple(scales.shape)} on {scales.device}")
    if out_dtype not in OUT_DTYPES:
        raise ValueError(f"paged_gather_dequant kernel writes bf16 or f32, "
                         f"not {out_dtype}")
    r, m = tables.shape
    out = torch.empty((r, m * p, d), dtype=out_dtype, device=pool.device)
    if out.numel() == 0:
        return out
    rc = _lib().paged_gather_dequant(
        pool.data_ptr(), scales.data_ptr(), tables.data_ptr(),
        int(tables.dtype == torch.int64), out.data_ptr(),
        int(out_dtype == torch.bfloat16), r * m, n, p, d, _stream(pool))
    if rc != 0:
        raise RuntimeError(f"paged_gather_dequant kernel launch failed: "
                           f"cudaError {rc}")
    paged_gather_dequant_cuda.launches += 1
    return out


paged_gather_cuda.launches = 0
paged_gather_dequant_cuda.launches = 0
