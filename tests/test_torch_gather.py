"""The int8 paged gather for a layer's K and V, and the dequant kernel's
launch plan, on the CPU.

``kernels.ops.paged_gather_dequant_kv`` on CPU tensors is two calls of
the plain single-pool version; it is held here bit for bit to those two
calls and to the reference's ``paged_gather_dequant_pallas`` in
interpret mode on both pools (ids past the last page clamp to N-1 in
both), and to the reference's jnp oracle for negative ids (clamped to
page 0; the Pallas interpreter wraps them). ``paged_gather.dequant_plan``
is pure Python: its path, chunks, ring and grid are checked for the
shapes ``chip_smoke.py`` runs on the card. The CUDA kernel itself runs
only on the card (``tests/test_torch_cuda.py``).
"""
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro_torch.kernels import ops

# ``repro_torch.kernels`` re-exports the op ``paged_gather`` over the module
kpg = importlib.import_module("repro_torch.kernels.paged_gather")

# one intra-op thread: the suite's pytest-xdist workers share the
# cores, and oversubscribed OpenMP pools spin against each other
torch.set_num_threads(1)

# ``repro.kernels`` re-exports a function named paged_gather over the module
jpg = importlib.import_module("repro.kernels.paged_gather")

# (N, P, D, R, M): as tests/test_torch_kernels.py's GATHER_SHAPES
GATHER_SHAPES = [(9, 8, 32, 4, 8), (7, 3, 13, 3, 5), (11, 5, 7, 4, 3),
                 (4, 2, 1, 5, 2)]
OUT = {"float32": (jnp.float32, torch.float32),
       "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _kv_inputs(shape, seed=0):
    """Two int8 pools with their f32 row scales, and (R, M) ids of which
    some lie past the last page."""
    n, p, d, r, m = shape
    rng = np.random.default_rng(seed)
    pools = [rng.integers(-127, 128, (n, p, d)).astype(np.int8)
             for _ in range(2)]
    scales = [(rng.random((n, p, 1)) / 127).astype(np.float32)
              for _ in range(2)]
    tables = rng.integers(0, n + 3, (r, m)).astype(np.int32)
    return pools, scales, tables


def _np(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) else \
        np.asarray(x.astype(jnp.float32))


@pytest.mark.parametrize("tdt", [torch.int32, torch.int64],
                         ids=["int32", "int64"])
@pytest.mark.parametrize("out", sorted(OUT))
@pytest.mark.parametrize("shape", GATHER_SHAPES,
                         ids=["x".join(map(str, s)) for s in GATHER_SHAPES])
def test_plain_kv_gather_matches_single_and_pallas(shape, out, tdt):
    """Bit for bit: the K and V route equals two single-pool calls and the
    reference's Pallas kernel (interpret mode) on each pool."""
    pools, scales, tables = _kv_inputs(shape)
    jdt, odt = OUT[out]
    tp = [torch.from_numpy(a) for a in pools]
    ts = [torch.from_numpy(a) for a in scales]
    t = torch.from_numpy(tables).to(tdt)
    got = ops.paged_gather_dequant_kv(tp[0], ts[0], tp[1], ts[1], t, odt)
    assert len(got) == 2
    for g, q, s, a, sc in zip(got, tp, ts, pools, scales):
        single = ops.paged_gather_dequant(q, s, t, odt)
        want = jpg.paged_gather_dequant_pallas(
            jnp.asarray(a), jnp.asarray(sc), jnp.asarray(tables), jdt,
            interpret=True)
        assert g.dtype == odt and g.shape == want.shape
        assert torch.equal(g, single)
        np.testing.assert_array_equal(_np(g), _np(want))


@pytest.mark.parametrize("out", sorted(OUT))
def test_plain_kv_gather_clamps_negative_ids_like_reference_oracle(out):
    """Ids below 0 and past N-1 on both pools, against the reference's jnp
    oracle (``repro.kernels.ref``), whose clamp rule the port keeps."""
    pools, scales, _ = _kv_inputs(GATHER_SHAPES[1], seed=3)
    tables = np.array([[-3, -1, 0, 2, 9], [6, 7, -2, 1, 40]], np.int32)
    jdt, odt = OUT[out]
    got = ops.paged_gather_dequant_kv(
        *(torch.from_numpy(a) for a in (pools[0], scales[0], pools[1],
                                        scales[1])),
        torch.from_numpy(tables), odt)
    for g, a, sc in zip(got, pools, scales):
        want = jref.paged_gather_dequant_ref(jnp.asarray(a), jnp.asarray(sc),
                                             jnp.asarray(tables), jdt)
        np.testing.assert_array_equal(_np(g), _np(want))


def _plan(p, d, n_pools, rm, pool_mod=0, out_mod=0, out=torch.bfloat16,
          scales_mod=0, n_pages=257):
    return kpg.dequant_plan(p, d, n_pools, rm, pool_mod, out_mod, out,
                            scales_addr_mod16=scales_mod, n_pages=n_pages,
                            sms=132)


# chip_smoke.phase_paged_gather's shapes and the plan each must get:
# (P, D, pools, R*M, N) -> (path, chunk rows, chunk cols, items, stages,
# grid, threads)
PLANS = [
    ((16, 1024, 1, 8 * 16, 257), ("tma", 4, 1024, 512, 4, 396, 288)),
    ((16, 1024, 2, 8 * 16, 257), ("tma", 4, 1024, 1024, 4, 396, 288)),
    ((16, 1024, 1, 32 * 64, 2049),
     ("tma", 16, 1024, 2048, 4, 396, 288)),
    ((16, 1024, 2, 32 * 64, 2049),
     ("tma", 16, 1024, 4096, 4, 396, 288)),
    ((3, 13, 1, 3 * 5, 7), ("scalar", 3, 13, 15, 0, 15, 256)),
    ((5, 7, 2, 4 * 3, 11), ("scalar", 5, 7, 24, 0, 24, 256)),
    ((2, 1, 1, 5 * 2, 9), ("scalar", 2, 1, 10, 0, 10, 256)),
    # a page of 64 rows (64 KB) cut into chunks of 4 rows (few items)
    ((64, 1024, 1, 12, 9), ("tma", 4, 1024, 192, 4, 192, 288)),
    # rows of 32768 int8, longer than a stage, cut into 8 pieces each
    ((4, 32768, 2, 6, 5), ("tma", 1, 4096, 384, 4, 384, 288)),
    # the same rows with enough items: cut in two (16 KB stages)
    ((4, 32768, 2, 400, 5),
     ("tma", 1, 16384, 6400, 4, 396, 288)),
]


@pytest.mark.parametrize("args,want", PLANS,
                         ids=["decode", "decode kv", "prefill",
                              "prefill kv", "ragged a", "ragged b kv",
                              "ragged c", "large page", "rows cut",
                              "rows cut in two"])
def test_dequant_plan_for_chip_smoke_shapes(args, want):
    p, d, n_pools, rm, n = args
    plan = _plan(p, d, n_pools, rm, n_pages=n)
    got = (plan.path, plan.chunk_rows, plan.chunk_cols, plan.items,
           plan.stages, plan.grid, plan.threads)
    assert got == want
    assert plan.chunks_per_page * plan.chunk_rows * plan.chunk_cols == p * d
    assert plan.items == n_pools * rm * plan.chunks_per_page
    if plan.path == "tma":
        assert plan.stage_bytes == plan.chunk_rows * plan.chunk_cols
        assert plan.stage_bytes <= kpg.STAGE_MAX
        assert plan.stage_bytes % 16 == 0 and plan.slot_bytes % 16 == 0
        assert plan.slot_bytes >= (plan.chunk_rows + 3) * 4
        assert plan.smem_bytes == plan.stages * (
            plan.stage_bytes + plan.slot_bytes + 20)
        # three blocks of the ring fit in one SM's 227 KB
        assert kpg.BLOCKS_PER_SM * (plan.smem_bytes + 1024) <= 227 * 1024
    else:
        assert plan.stage_bytes == plan.smem_bytes == plan.stages == 0


@pytest.mark.parametrize("out", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
def test_dequant_plan_off_alignment(out):
    """What the TMA does not take stays in the kernel: a pool, output or
    scales base off 16 bytes, or N * P not a multiple of 4, takes the
    vector path where a piece (8 int8 for bf16, 4 for f32) fits the row
    and the base, else the scalar path."""
    vec = 8 if out == torch.bfloat16 else 4
    assert _plan(16, 1024, 1, 128, out=out).path == "tma"
    assert _plan(16, 1024, 1, 128, pool_mod=8, out=out).path == "vector"
    assert _plan(16, 1024, 1, 128, pool_mod=vec, out=out).path == "vector"
    assert _plan(16, 1024, 1, 128, pool_mod=2, out=out).path == "scalar"
    assert _plan(16, 1024, 1, 128, pool_mod=1, out=out).path == "scalar"
    assert _plan(16, 1024, 1, 128, out_mod=8, out=out).path == "scalar"
    assert _plan(16, 1024, 1, 128, scales_mod=4, out=out).path == "vector"
    assert _plan(3, 1024, 1, 128, n_pages=7, out=out).path == "vector"
    assert _plan(16, 24, 1, 128, out=out).path == \
        ("vector" if 24 % vec == 0 else "scalar")
    assert _plan(16, 12, 1, 128, out=out).path == \
        ("scalar" if vec == 8 else "vector")


def test_dequant_plan_refuses_other_outputs():
    with pytest.raises(ValueError, match="bf16 or f32"):
        _plan(16, 1024, 1, 128, out=torch.float16)

