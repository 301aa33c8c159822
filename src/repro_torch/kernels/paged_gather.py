"""Wrappers of the CUDA paged gathers (``csrc/paged_gather.cu``):

    out[r, j*P:(j+1)*P, :] = pool[clamp(tables[r, j], 0, N-1)]

from a (N, P, D) pool of any dtype, for one pool or for two pools that
share the table in one launch (a layer's K and V, MLA's latents c and
kpe: their row widths may differ), and the int8 variant that multiplies
each page row by its f32 scale and writes bf16 or f32, for one pool or
for a layer's K and V pools in one launch.

Counterparts of ``repro.kernels.paged_gather.paged_gather_pallas`` and
``paged_gather_dequant_pallas`` (a two-pool launch is two calls of
either). CUDA tensors only; ``kernels.ops`` routes CPU tensors to the
plain versions (``kernels.ref``). Each wrapper counts its launches in
``.launches``. :func:`gather_plan` and :func:`dequant_plan` are the two
kernels' launch plans, pure Python so that the CPU tests reach them.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Optional, Tuple

import torch

from . import build

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
OUT_DTYPES = (torch.bfloat16, torch.float32)

# The dequant kernel's launch plan (see csrc/paged_gather.cu).
PATHS = ("tma", "vector", "scalar")
STAGE_MAX = 16384       # int8 bytes of one ring stage at most
STAGE_MIN = 4096        # chunks are not cut below this to make more items
STAGES = 4              # ring depth: 4 x 16 KB + scales, 3 blocks an SM
BLOCKS_PER_SM = 3
CONSUMERS = 256         # converting threads a block (warps 1-8 on TMA)
H100_SMS = 132

# The copy gather's blocks (csrc/paged_gather.cu: THREADS x UNROLL units
# a block).
COPY_THREADS = 128
COPY_CHUNK_UNITS = 4 * COPY_THREADS
COPY_MAX_CHUNKS = 65535  # chunks of a launch's pages, gridDim.y at most
UNITS = (16, 8, 4, 2, 1)


@dataclasses.dataclass(frozen=True)
class DequantPlan:
    """How one dequant launch runs. ``path``: "tma" (a ring of shared-memory
    stages filled by the TMA, warp 0 the producer), "vector" (pieces of 8
    or 4 int8 read from device memory) or "scalar" (one element a step).
    A work item is ``chunk_rows`` x ``chunk_cols`` elements of one page of
    one pool (rows are cut only when one row exceeds a stage); ``items``
    of them walked by ``grid`` persistent blocks of ``threads``.
    ``stage_bytes``, ``slot_bytes`` (a stage's scales), ``stages`` and
    ``smem_bytes`` are 0 off the TMA path."""
    path: str
    chunk_rows: int
    chunk_cols: int
    chunks_per_page: int
    items: int
    stage_bytes: int
    slot_bytes: int
    stages: int
    grid: int
    threads: int
    smem_bytes: int


@dataclasses.dataclass(frozen=True)
class GatherPlan:
    """How one copy-gather launch runs: every thread moves ``unit`` bytes
    at once (the widest of ``UNITS`` that divides every pool's page and
    every base), a block of ``threads`` copies one ``chunk`` of bytes of
    one page slot (a page's last chunk may be shorter),
    ``chunks_per_page[p]`` a page of pool p; ``grid`` is (page slots,
    chunks of a page of every pool), ``items`` its blocks."""
    unit: int
    chunk: int
    chunks_per_page: Tuple[int, ...]
    items: int
    grid: Tuple[int, int]
    threads: int


@functools.lru_cache(maxsize=None)
def gather_plan(pages: Tuple[Tuple[int, int], ...], rm: int, itemsize: int,
                addr_mod16: Optional[Tuple[int, ...]] = None) -> GatherPlan:
    """The launch plan of one or two pools through ``rm`` page slots:
    ``pages[p]`` = (P, D) of pool p, elements of ``itemsize`` bytes.
    ``addr_mod16[p]``: pool p's base and its output's, or-ed, modulo 16
    (default: aligned). Cached: the attention asks for a few plans, once
    a layer a step."""
    sizes = [p * d * itemsize for p, d in pages]
    mods = tuple(addr_mod16) if addr_mod16 is not None else (0,) * len(sizes)
    if not 1 <= len(sizes) <= 2 or len(mods) != len(sizes):
        raise ValueError(f"gather_plan: one or two pools, got pages "
                         f"{tuple(pages)} and bases {mods}")
    unit = next(u for u in UNITS
                if all(b % u == 0 for b in sizes) and
                all(m % u == 0 for m in mods))
    chunk = unit * COPY_CHUNK_UNITS
    per_page = tuple(-(-b // chunk) for b in sizes)
    return GatherPlan(unit, chunk, per_page, rm * sum(per_page),
                      (rm, sum(per_page)), COPY_THREADS)


def _divisors_down(n: int, cap: int):
    return [d for d in range(min(n, cap), 0, -1) if n % d == 0]


def dequant_plan(P: int, D: int, n_pools: int, rm: int,
                 pool_addr_mod16: int, out_addr_mod16: int, out_dtype,
                 scales_addr_mod16: int = 0, n_pages: int = 4,
                 sms: int = H100_SMS) -> DequantPlan:
    """The launch plan of ``n_pools`` (1, or 2 for K and V) int8 pools of
    ``n_pages`` pages (P, D), ``rm`` page slots, writing ``out_dtype``.
    The ``*_mod16`` are the base addresses modulo 16 (for two pools, of
    either: any misalignment counts).

    TMA when every bulk copy is 16-byte aligned: D % 16 == 0, pools,
    output and scales on 16 bytes, and ``n_pages * P`` a multiple of 4 (a
    chunk's scales are copied as the 16-byte span around them). Else the
    vector path when a piece (8 int8 for bf16 out, 4 for f32) never
    crosses a row and the pools and output allow its loads and 16-byte
    stores; else the scalar path. Chunks: whole rows, as many as divide P
    and fit ``STAGE_MAX`` bytes, halved while that leaves fewer than two
    items for every block the card holds (down to ``STAGE_MIN``); a row
    longer than a stage (TMA only) is cut into equal pieces of at most a
    stage."""
    if out_dtype not in OUT_DTYPES:
        raise ValueError(f"paged_gather_dequant writes bf16 or f32, not "
                         f"{out_dtype}")
    vec = 8 if out_dtype == torch.bfloat16 else 4
    if (D % 16 == 0 and pool_addr_mod16 == 0 and out_addr_mod16 == 0
            and scales_addr_mod16 == 0 and (n_pages * P) % 4 == 0):
        path = "tma"
    elif (D % vec == 0 and pool_addr_mod16 % vec == 0
          and out_addr_mod16 == 0):
        path = "vector"
    else:
        path = "scalar"
    full_grid = BLOCKS_PER_SM * sms

    def chunk(cap):
        if D > cap and path == "tma":
            w = next(w for w in _divisors_down(D, cap) if w % 16 == 0)
            return 1, w
        return next(c for c in _divisors_down(P, max(cap // D, 1))), D

    cap = STAGE_MAX
    rows, cols = chunk(cap)
    while (cap > STAGE_MIN and n_pools * rm * (P * D // (rows * cols))
           < 2 * full_grid):
        cap //= 2
        rows, cols = chunk(cap)
    per_page = P * D // (rows * cols)
    items = n_pools * rm * per_page
    grid = max(1, min(items, full_grid))
    if path != "tma":
        return DequantPlan(path, rows, cols, per_page, items, 0, 0, 0, grid,
                           CONSUMERS, 0)
    stage = rows * cols
    slot = -(-(rows + 3) * 4 // 16) * 16
    return DequantPlan(path, rows, cols, per_page, items, stage, slot,
                       STAGES, grid, 32 + CONSUMERS,
                       STAGES * (stage + slot + 16 + 4))


@functools.lru_cache(maxsize=None)
def _lib():
    lib = build.load("paged_gather")
    lib.paged_gather.argtypes = [_P, _P, _I, _P, _L, _L, _L, _I, _P]
    lib.paged_gather.restype = ctypes.c_int
    lib.paged_gather_kv.argtypes = [_P, _P, _P, _I, _P, _P, *[_L] * 5, _I,
                                    _P]
    lib.paged_gather_kv.restype = ctypes.c_int
    plan = [_I] * 9
    lib.paged_gather_dequant.argtypes = [_P, _P, _P, _I, _P, _I, _L, _L, _I,
                                         _I, *plan, _P]
    lib.paged_gather_dequant.restype = ctypes.c_int
    lib.paged_gather_dequant_kv.argtypes = [_P, _P, _P, _P, _P, _I, _P, _I,
                                            _L, _L, _I, _I, *plan, _P]
    lib.paged_gather_dequant_kv.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=None)
def _sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


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


def _gather_plan(pools, outs, tables) -> GatherPlan:
    """The plan of a copy gather of ``pools`` into ``outs``; refuses what
    the kernel's 32-bit indices and grid cannot take."""
    plan = gather_plan(tuple((t.shape[1], t.shape[2]) for t in pools),
                       tables.numel(), pools[0].element_size(),
                       tuple((t.data_ptr() | o.data_ptr()) % 16
                             for t, o in zip(pools, outs)))
    if plan.grid[1] > COPY_MAX_CHUNKS or any(
            t.shape[0] >= 2 ** 31
            or t.shape[1] * t.shape[2] * t.element_size() >= 2 ** 30
            for t in pools):
        raise ValueError(f"paged_gather kernel: pages of "
                         f"{[tuple(t.shape) for t in pools]} exceed its "
                         f"32-bit indices or its grid")
    return plan


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
    plan = _gather_plan((pool,), (out,), tables)
    rc = _lib().paged_gather(pool.data_ptr(), tables.data_ptr(),
                             int(tables.dtype == torch.int64),
                             out.data_ptr(), r * m, n,
                             p * d * pool.element_size(), plan.unit,
                             _stream(pool))
    if rc != 0:
        raise RuntimeError(f"paged_gather kernel launch failed: "
                           f"cudaError {rc}")
    paged_gather_cuda.launches += 1
    return out


def paged_gather_kv_cuda(pool_a: torch.Tensor, pool_b: torch.Tensor,
                         tables: torch.Tensor
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Two pools through one table in one launch (a layer's K and V, or
    MLA's c and kpe): pool_a (N_a, P_a, D_a) and pool_b (N_b, P_b, D_b) of
    one dtype, tables (R, M) -> (a (R, M*P_a, D_a), b (R, M*P_b, D_b)),
    views of one buffer (b's starts on 16 bytes).
    ``paged_gather_kv_cuda.launches`` counts launches."""
    for pool in (pool_a, pool_b):
        _check("paged_gather_kv", pool, tables)
    if pool_b.dtype != pool_a.dtype or pool_b.device != pool_a.device:
        raise ValueError(f"paged_gather_kv kernel takes two pools of one "
                         f"dtype on one device, got {pool_a.dtype} on "
                         f"{pool_a.device} and {pool_b.dtype} on "
                         f"{pool_b.device}")
    r, m = tables.shape
    (na_, pa, da), (nb_, pb, db) = pool_a.shape, pool_b.shape
    size = pool_a.element_size()
    na, nb = r * m * pa * da, r * m * pb * db
    off = -(-na * size // 16) * 16 // size
    buf = torch.empty(off + nb, dtype=pool_a.dtype, device=pool_a.device)
    a = buf[:na].view(r, m * pa, da)
    b = buf[off:off + nb].view(r, m * pb, db)
    if na == 0 and nb == 0:
        return a, b
    if na == 0 or nb == 0:
        raise ValueError(f"paged_gather_kv kernel: one pool has empty pages "
                         f"({tuple(pool_a.shape)}, {tuple(pool_b.shape)})")
    plan = _gather_plan((pool_a, pool_b), (a, b), tables)
    rc = _lib().paged_gather_kv(
        pool_a.data_ptr(), pool_b.data_ptr(), tables.data_ptr(),
        int(tables.dtype == torch.int64), a.data_ptr(), b.data_ptr(), r * m,
        na_, nb_, pa * da * size, pb * db * size, plan.unit,
        _stream(pool_a))
    if rc != 0:
        raise RuntimeError(f"paged_gather_kv kernel launch failed: "
                           f"cudaError {rc}")
    paged_gather_kv_cuda.launches += 1
    return a, b


def _check_dequant(name, pools, scales, tables, out_dtype):
    """The int8 pools (all one shape) and their scales, as the kernel
    takes them."""
    for pool in pools:
        _check(name, pool, tables)
    n, p, d = pools[0].shape
    for pool, sc in zip(pools, scales):
        if pool.dtype != torch.int8 or pool.shape != pools[0].shape:
            raise ValueError(f"{name} kernel takes int8 pools of one shape, "
                             f"got {pool.dtype} {tuple(pool.shape)}")
        if (sc.dtype != torch.float32 or tuple(sc.shape) != (n, p, 1)
                or not sc.is_contiguous() or sc.device != pool.device):
            raise ValueError(f"{name} kernel: scales must be a contiguous "
                             f"float32 ({n}, {p}, 1) tensor on "
                             f"{pool.device}, got {sc.dtype} "
                             f"{tuple(sc.shape)} on {sc.device}")
    if out_dtype not in OUT_DTYPES:
        raise ValueError(f"{name} kernel writes bf16 or f32, not "
                         f"{out_dtype}")
    r, m = tables.shape
    if len(pools) * r * m * p * d >= 2 ** 31 or n * p >= 2 ** 31:
        raise ValueError(f"{name} kernel: {len(pools)} x {r * m} pages of "
                         f"{p} x {d} exceed its 32-bit item indices")


def _plan_for(pools, scales, out, tables):
    n, p, d = pools[0].shape
    mod = 0
    for t in pools:
        mod |= t.data_ptr() % 16
    smod = 0
    for t in scales:
        smod |= t.data_ptr() % 16
    return dequant_plan(p, d, len(pools), tables.numel(), mod,
                        out.data_ptr() % 16, out.dtype,
                        scales_addr_mod16=smod, n_pages=n,
                        sms=_sms(out.device.index or 0))


def _plan_args(plan: DequantPlan):
    return (PATHS.index(plan.path), plan.chunk_rows, plan.chunk_cols,
            plan.stages, plan.stage_bytes, plan.slot_bytes, plan.grid,
            plan.threads, plan.smem_bytes)


def paged_gather_dequant_cuda(pool: torch.Tensor, scales: torch.Tensor,
                              tables: torch.Tensor,
                              out_dtype=torch.float32) -> torch.Tensor:
    """pool (N, P, D) int8; scales (N, P, 1) float32 row scales; tables
    (R, M) int32/int64 -> (R, M*P, D) ``out_dtype`` (bf16 or f32).
    ``paged_gather_dequant_cuda.launches`` counts launches."""
    _check_dequant("paged_gather_dequant", (pool,), (scales,), tables,
                   out_dtype)
    n, p, d = pool.shape
    r, m = tables.shape
    out = torch.empty((r, m * p, d), dtype=out_dtype, device=pool.device)
    if out.numel() == 0:
        return out
    plan = _plan_for((pool,), (scales,), out, tables)
    rc = _lib().paged_gather_dequant(
        pool.data_ptr(), scales.data_ptr(), tables.data_ptr(),
        int(tables.dtype == torch.int64), out.data_ptr(),
        int(out_dtype == torch.bfloat16), r * m, n, p, d, *_plan_args(plan),
        _stream(pool))
    if rc != 0:
        raise RuntimeError(f"paged_gather_dequant kernel launch failed: "
                           f"cudaError {rc}")
    paged_gather_dequant_cuda.launches += 1
    return out


def paged_gather_dequant_kv_cuda(k_pool: torch.Tensor,
                                 k_scales: torch.Tensor,
                                 v_pool: torch.Tensor,
                                 v_scales: torch.Tensor,
                                 tables: torch.Tensor,
                                 out_dtype=torch.float32):
    """A layer's K and V gathers in one launch: two int8 pools of one shape
    (N, P, D) with their (N, P, 1) f32 scales, one table (R, M) ->
    (k, v), each (R, M*P, D) ``out_dtype``, views of one buffer.
    ``paged_gather_dequant_kv_cuda.launches`` counts launches."""
    pools, scales = (k_pool, v_pool), (k_scales, v_scales)
    _check_dequant("paged_gather_dequant_kv", pools, scales, tables,
                   out_dtype)
    n, p, d = k_pool.shape
    r, m = tables.shape
    out = torch.empty((2, r, m * p, d), dtype=out_dtype,
                      device=k_pool.device)
    if out.numel() == 0:
        return out[0], out[1]
    plan = _plan_for(pools, scales, out, tables)
    rc = _lib().paged_gather_dequant_kv(
        k_pool.data_ptr(), k_scales.data_ptr(), v_pool.data_ptr(),
        v_scales.data_ptr(), tables.data_ptr(),
        int(tables.dtype == torch.int64), out.data_ptr(),
        int(out_dtype == torch.bfloat16), r * m, n, p, d, *_plan_args(plan),
        _stream(k_pool))
    if rc != 0:
        raise RuntimeError(f"paged_gather_dequant_kv kernel launch failed: "
                           f"cudaError {rc}")
    paged_gather_dequant_kv_cuda.launches += 1
    return out[0], out[1]


paged_gather_cuda.launches = 0
paged_gather_kv_cuda.launches = 0
paged_gather_dequant_cuda.launches = 0
paged_gather_dequant_kv_cuda.launches = 0
