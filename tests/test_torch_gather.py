"""The two-pool paged gathers (a layer's K and V, or MLA's c and kpe, in
one launch), bf16 / f32 and int8, and the two kernels' launch plans, on
the CPU.

``kernels.ops.paged_gather_kv`` and ``paged_gather_dequant_kv`` on CPU
tensors are two calls of the plain single-pool version; each is held
here bit for bit to those two calls and to the reference's Pallas kernel
(``paged_gather_pallas``, ``paged_gather_dequant_pallas``) in interpret
mode on both pools (ids past the last page clamp to N-1 in both), and to
the reference's jnp oracle for negative ids (clamped to page 0; the
Pallas interpreter wraps them). ``paged_gather.gather_plan`` and
``dequant_plan`` are pure Python: their paths, chunks, rings and grids
are checked for the shapes ``chip_smoke.py`` runs on the card. The CUDA
kernels themselves run only on the card (``tests/test_torch_cuda.py``).
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



# -- the copy gather: a layer's two pools in one launch --------------------

# row widths of the second pool of a pair, by the first's: the same (K and
# V), and another (MLA's c and kpe; an odd width)
PAIRS = {"equal": lambda d: d, "unequal": lambda d: 2 * d + 1}
COPY = {"float32": (jnp.float32, torch.float32),
        "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _pair_inputs(shape, d_b, dtype, seed=0, lo=0):
    """Two pools of one dtype (rows of D and of ``d_b``) and (R, M) ids
    from ``lo`` to past the last page, as numpy (f32 for the pools)."""
    n, p, d, r, m = shape
    rng = np.random.default_rng(seed)
    jdt = COPY[dtype][0]
    pools = [np.array(jnp.asarray(rng.standard_normal((n, p, w)) * 8,
                                  jnp.float32).astype(jdt)
                      .astype(jnp.float32)) for w in (d, d_b)]
    tables = rng.integers(lo, n + 3, (r, m)).astype(np.int32)
    return pools, tables


@pytest.mark.parametrize("tdt", [torch.int32, torch.int64],
                         ids=["int32", "int64"])
@pytest.mark.parametrize("dtype", sorted(COPY))
@pytest.mark.parametrize("pair", sorted(PAIRS))
@pytest.mark.parametrize("shape", GATHER_SHAPES,
                         ids=["x".join(map(str, s)) for s in GATHER_SHAPES])
def test_plain_pair_gather_matches_single_and_pallas(shape, pair, dtype,
                                                     tdt):
    """Bit for bit: the two-pool route equals two single-pool calls and the
    reference's Pallas kernel (interpret mode) on each pool."""
    pools, tables = _pair_inputs(shape, PAIRS[pair](shape[2]), dtype)
    jdt, tdtype = COPY[dtype]
    tp = [torch.from_numpy(a).to(tdtype) for a in pools]
    t = torch.from_numpy(tables).to(tdt)
    got = ops.paged_gather_kv(tp[0], tp[1], t)
    assert len(got) == 2
    for g, pool, a in zip(got, tp, pools):
        want = jpg.paged_gather_pallas(jnp.asarray(a, jdt),
                                       jnp.asarray(tables), interpret=True)
        assert g.dtype == tdtype and g.shape == want.shape
        assert torch.equal(g, ops.paged_gather(pool, t))
        np.testing.assert_array_equal(_np(g), _np(want))


@pytest.mark.parametrize("dtype", sorted(COPY))
def test_plain_pair_gather_clamps_negative_ids_like_reference_oracle(dtype):
    """Ids below 0 and past N-1 on both pools (rows of 13 and of 4),
    against the reference's jnp oracle (``repro.kernels.ref``)."""
    pools, _ = _pair_inputs(GATHER_SHAPES[1], 4, dtype, seed=3)
    tables = np.array([[-3, -1, 0, 2, 9], [6, 7, -2, 1, 40]], np.int32)
    jdt, tdtype = COPY[dtype]
    got = ops.paged_gather_kv(*(torch.from_numpy(a).to(tdtype)
                                for a in pools), torch.from_numpy(tables))
    for g, a in zip(got, pools):
        want = jref.paged_gather_ref(jnp.asarray(a, jdt), jnp.asarray(tables))
        np.testing.assert_array_equal(_np(g), _np(want))


class _OnCard(torch.Tensor):
    """A CPU tensor that reports itself as a CUDA one: the dispatcher takes
    its kernel route, and refuses before it reaches the kernel."""

    @property
    def is_cuda(self):
        return True


def test_pair_gather_refuses_input_that_requires_grad(monkeypatch):
    """As the other gathers: with grad mode on, an input that requires
    grad is refused on the kernel route (the kernel has no backward);
    under torch.no_grad() the kernel is called."""
    called = []
    monkeypatch.setattr(kpg, "paged_gather_kv_cuda",
                        lambda a, b, t: called.append(1) or (a, b))
    tables = torch.zeros(2, 3, dtype=torch.long)
    for which in range(2):
        pools = [torch.randn(5, 4, 8).as_subclass(_OnCard) for _ in range(2)]
        pools[which].requires_grad_()
        with pytest.raises(RuntimeError, match="no backward"):
            ops.paged_gather_kv(pools[0], pools[1], tables)
        assert len(called) == which
        with torch.no_grad():
            ops.paged_gather_kv(pools[0], pools[1], tables)
        assert len(called) == which + 1


def _gplan(pages, rm, size=2, mods=None):
    return kpg.gather_plan(tuple(pages), rm, size,
                           None if mods is None else tuple(mods))


# chip_smoke.py's copy-gather shapes and the plan each must get: ((P, D)
# of each pool, R*M, bytes an element) -> (unit, chunks a page, items,
# grid). A block copies 512 units of one page slot; the grid is (slots,
# chunks of a page of every pool).
GATHER_PLANS = {
    "decode": ((((16, 1024),), 8 * 16, 2), (16, (4,), 512, (128, 4))),
    "decode kv": ((((16, 1024), (16, 1024)), 8 * 16, 2),
                  (16, (4, 4), 1024, (128, 8))),
    "prefill": ((((16, 1024),), 32 * 64, 2), (16, (4,), 8192, (2048, 4))),
    "prefill kv": ((((16, 1024), (16, 1024)), 32 * 64, 2),
                   (16, (4, 4), 16384, (2048, 8))),
    "prefill f32": ((((16, 1024),), 32 * 64, 4),
                    (16, (8,), 16384, (2048, 8))),
    "prefill int8": ((((16, 1024),), 32 * 64, 1),
                     (16, (2,), 4096, (2048, 2))),
    "ragged a": ((((3, 13),), 3 * 5, 2), (2, (1,), 15, (15, 1))),
    "ragged b kv": ((((5, 7), (5, 7)), 4 * 3, 4), (4, (1, 1), 24, (12, 2))),
    "ragged c": ((((2, 1),), 5 * 2, 1), (2, (1,), 10, (10, 1))),
    "deepseek c+kpe": ((((16, 512), (16, 64)), 8 * 16, 2),
                       (16, (2, 1), 384, (128, 3))),
    "pages of 16 and 4 rows": ((((16, 512), (4, 64)), 8 * 16, 2),
                               (16, (2, 1), 384, (128, 3))),
    "hymba kv": ((((16, 320), (16, 320)), 8 * 16, 2),
                 (16, (2, 2), 512, (128, 4))),
    "qwen2-vl kv": ((((16, 256), (16, 256)), 8 * 16, 2),
                    (16, (1, 1), 256, (128, 2))),
    "moonshot kv": ((((16, 2048), (16, 2048)), 8 * 16, 2),
                    (16, (8, 8), 2048, (128, 16))),
    "tp2 shard kv": ((((16, 512), (16, 512)), 8 * 16, 2),
                     (16, (2, 2), 512, (128, 4))),
    # the enc-dec memory pool: a 2 MiB page a row through a width-1 table
    "memory": ((((1024, 1024),), 8, 2), (16, (256,), 2048, (8, 256))),
}


@pytest.mark.parametrize("case", sorted(GATHER_PLANS))
def test_gather_plan_for_chip_smoke_shapes(case):
    (pages, rm, size), want = GATHER_PLANS[case]
    plan = _gplan(pages, rm, size)
    assert (plan.unit, plan.chunks_per_page, plan.items, plan.grid) == want
    sizes = [p * d * size for p, d in pages]
    # the widest unit that divides every page
    assert plan.unit == max(u for u in kpg.UNITS
                            if all(b % u == 0 for b in sizes))
    assert plan.chunk == plan.unit * kpg.COPY_CHUNK_UNITS
    for page, per_page in zip(sizes, plan.chunks_per_page):
        # a page is cut into chunks of a block each, the last not empty
        assert 0 < page - (per_page - 1) * plan.chunk <= plan.chunk
    assert plan.items == rm * sum(plan.chunks_per_page) == \
        plan.grid[0] * plan.grid[1]
    assert plan.threads == kpg.COPY_THREADS
    assert plan.grid[1] <= kpg.COPY_MAX_CHUNKS


def test_gather_plan_off_alignment():
    """A pool or output base, or a page, not on 16 bytes, in either pool
    of a pair, runs in the same kernel at the widest unit that divides
    every page and every base of the launch."""
    rm = 32 * 64
    assert _gplan(((16, 1024), (16, 1024)), rm).unit == 16
    for mods, unit in (((8, 0), 8), ((0, 8), 8), ((2, 4), 2), ((1, 0), 1),
                       ((4, 12), 4)):
        plan = _gplan(((16, 1024), (16, 1024)), rm, mods=mods)
        assert plan.unit == unit
        assert plan.chunks_per_page == (-(-32768 // plan.chunk),) * 2
    # rows of 3 and 7 bf16 (6 and 14 bytes) make pages of 96 and 224
    # bytes, both on 16
    assert _gplan(((16, 3), (16, 7)), 2 ** 10).unit == 16
    # one ragged pool of a pair: its 2-byte pages narrow both pools' unit
    assert _gplan(((1, 2 ** 16), (1, 1)), rm).unit == 2
    assert _gplan(((3, 13),), 15, size=1).unit == 1


def test_gather_plan_is_cached():
    """The attention asks for the same few plans once a layer a step:
    the second call returns the first call's plan."""
    pages = ((16, 1024), (16, 1024))
    assert _gplan(pages, 128) is _gplan(pages, 128)
    assert _gplan(pages, 128) is not _gplan(pages, 256)


def test_gather_plan_refuses_pages_past_the_kernels_indices():
    """Pages of 1 GiB or more, or more chunks than the grid holds, are
    refused before any launch (the pools are stride-0 views: no memory)."""
    one = torch.zeros(1, 1, 1)
    tables = torch.zeros(1, 1, dtype=torch.int32)
    ok = one.expand(2, 16, 1024)
    assert kpg._gather_plan((ok,), (ok,), tables).unit == 16
    for big in (one.expand(2, 2 ** 15, 2 ** 13),     # 1 GiB a page
                one.expand(2, 2 ** 14, 2 ** 13)):    # 65536 chunks a page
        with pytest.raises(ValueError, match="32-bit indices"):
            kpg._gather_plan((big,), (ok,), tables)
        with pytest.raises(ValueError, match="32-bit indices"):
            kpg._gather_plan((ok, big), (ok, ok), tables)


def test_gather_plan_refuses_other_pool_counts():
    with pytest.raises(ValueError, match="one or two pools"):
        _gplan(((16, 8),) * 3, 4)
    with pytest.raises(ValueError, match="one or two pools"):
        _gplan(((16, 8),) * 2, 4, mods=(0,))
