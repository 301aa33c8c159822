"""The port's kernel dispatchers against the reference's, on the CPU.

On the CPU ``repro_torch.kernels.ops`` runs the plain PyTorch versions
(``repro_torch.kernels.ref``); they are held here to the reference's
Pallas kernels in interpret mode (``use_pallas=True``) and to its jnp
oracles, on the same inputs made with numpy. Tolerances: spinner
rtol=1e-4, atol=1e-5 (FFT, Kronecker and in-kernel sum orders differ);
srf_decode rtol=1e-5, atol=1e-6. In bf16 the plain spinner is held to
the Pallas kernel in interpret mode within one bf16 spacing per element
(rtol=2**-7): both compute in f32 and round once, on write. The plain
paged gathers equal the reference's Pallas kernels in interpret mode
bit for bit. fwht and circulant_project are held to the reference's
Pallas kernels in interpret mode and to its jnp oracles within
``tests/test_kernels.py``'s ``_tol`` (f32 2e-5; bf16 2e-2, and rtol
5e-2, atol 0.15 for exp and cos_sin, exp compared in log space). The
CUDA kernels themselves run only on the card:
``tests/test_torch_cuda.py``.
"""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import structured as jstructured
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import circulant as kcirc
from repro_torch.kernels import ops
from repro_torch.kernels import paged_gather as kpg
from repro_torch.kernels import spinner as kspin
from repro_torch.kernels import srf_decode as kdec

KINDS = ("circulant", "skew_circulant", "toeplitz", "hankel", "unstructured",
         "ldr")
EPILOGUES = ("identity", "relu", "heaviside", "sign", "exp", "cos_sin")
G, B, N, M = 2, 5, 16, 24


def _inputs(kind, seed=0):
    rng = np.random.default_rng(seed)
    keys = jax.random.split(jax.random.PRNGKey(seed), G)
    ps = [jstructured.init(k, kind, M, N, r=2) for k in keys]
    params = {name: np.stack([np.asarray(p[name]) for p in ps])
              for name in ps[0]}
    params["d0"] = np.sign(rng.standard_normal((G, N))).astype(np.float32)
    params["d1"] = np.sign(rng.standard_normal((G, N))).astype(np.float32)
    x = rng.standard_normal((G, B, N)).astype(np.float32)
    return params, x


def _far_from_step(y_identity, *arrays):
    """Step epilogues (heaviside, sign) flip where y is within float
    summation-order noise of 0: compare only where |y| is not."""
    far = np.abs(y_identity) > 1e-4 * np.abs(y_identity).max()
    return [a[far] for a in arrays]


def _jax(kind, params, x, epi, use_pallas):
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    return np.asarray(jops.spinner_project(
        kind, jp, jnp.asarray(x), M, epilogue=epi, y_scale=0.8,
        out_scale=M ** -0.5, grouped=True, use_pallas=use_pallas))


@pytest.mark.parametrize("epi", EPILOGUES)
@pytest.mark.parametrize("kind", KINDS)
def test_plain_spinner_matches_reference(kind, epi):
    params, x = _inputs(kind)
    got = ops.spinner_project(kind, {k: torch.from_numpy(v)
                                     for k, v in params.items()},
                              torch.from_numpy(x), M, epilogue=epi,
                              y_scale=0.8, out_scale=M ** -0.5,
                              grouped=True).numpy()
    want_ref = _jax(kind, params, x, epi, use_pallas=False)
    # the reference routes ldr to its oracle; every other kind runs the
    # Pallas kernel in interpret mode
    want_kernel = _jax(kind, params, x, epi, use_pallas=True)
    assert got.shape == want_ref.shape == want_kernel.shape
    for want in (want_ref, want_kernel):
        g, w = got, want
        if epi in ("heaviside", "sign"):
            y = _jax(kind, params, x, "identity", use_pallas=False)
            g, w = _far_from_step(y, got, want)
        np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-5)


def _bf16_inputs(kind, g, b, n, m, seed=0):
    """bf16-valued params and x (as f32 numpy; bf16 -> f32 is exact)."""
    rng = np.random.default_rng(seed)
    keys = jax.random.split(jax.random.PRNGKey(seed), g)
    ps = [jstructured.init(k, kind, m, n) for k in keys]
    params = {name: np.stack([np.asarray(p[name]) for p in ps])
              for name in ps[0]}
    params["d0"] = np.sign(rng.standard_normal((g, n))).astype(np.float32)
    params["d1"] = np.sign(rng.standard_normal((g, n))).astype(np.float32)
    x = (rng.standard_normal((g, b, n)) * n ** -0.25).astype(np.float32)
    bf = lambda a: np.array(jnp.asarray(a, jnp.bfloat16)  # noqa: E731
                            .astype(jnp.float32))
    return {k: bf(v) for k, v in params.items()}, bf(x)


BF16_CASES = [*[(kind, epi, (G, B, N, M)) for kind in KINDS[:5]
                for epi in EPILOGUES],
              # the serving path's own shapes: circulant n=128, m=256,
              # G=8 kv heads; decode query (B=32, identity) and decode
              # key (B=8, exp)
              ("circulant", "identity", (8, 32, 128, 256)),
              ("circulant", "exp", (8, 8, 128, 256))]


@pytest.mark.parametrize("kind,epi,shape", BF16_CASES, ids=[
    f"{k}-{e}-" + "x".join(map(str, s)) for k, e, s in BF16_CASES])
def test_plain_spinner_bf16_matches_pallas(kind, epi, shape):
    """The port's bf16 numerics are the TPU kernel's: f32 from load to one
    cast on write. The reference's jnp oracle instead rounds y to bf16
    before the epilogue and differs from its own kernel by several bf16
    spacings on about 60% of the elements; the port differs from the
    kernel by at most one spacing, on under 0.1% of them."""
    g, b, n, m = shape
    params, x = _bf16_inputs(kind, g, b, n, m)
    kw = dict(epilogue=epi, y_scale=0.8, out_scale=m ** -0.5, grouped=True)
    got = ops.spinner_project(
        kind, {k: torch.from_numpy(v).bfloat16() for k, v in params.items()},
        torch.from_numpy(x).bfloat16(), m, **kw)
    assert got.dtype == torch.bfloat16
    want = jops.spinner_project(
        kind, {k: jnp.asarray(v, jnp.bfloat16) for k, v in params.items()},
        jnp.asarray(x, jnp.bfloat16), m, use_pallas=True, **kw)
    assert want.dtype == jnp.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               rtol=2 ** -7, atol=1e-6)


def test_plain_spinner_ungrouped_matches_grouped():
    params, x = _inputs("circulant", seed=1)
    tp = {k: torch.from_numpy(v) for k, v in params.items()}
    grouped = ops.spinner_project("circulant", tp, torch.from_numpy(x), M,
                                  epilogue="exp", grouped=True)
    one = ops.spinner_project("circulant", {k: v[1] for k, v in tp.items()},
                              torch.from_numpy(x[1]).reshape(1, B, N), M,
                              epilogue="exp")
    assert one.shape == (1, B, M)
    torch.testing.assert_close(one[0], grouped[1], rtol=0, atol=0)


def test_plain_srf_decode_matches_reference():
    rng = np.random.default_rng(2)
    b, h, m, dv = 3, 4, 24, 8
    s = rng.standard_normal((b, h, m, dv)).astype(np.float32)
    z = rng.random((b, h, m)).astype(np.float32) * 4
    pq = rng.random((b, h, m)).astype(np.float32)
    pk = rng.random((b, h, m)).astype(np.float32)
    v = rng.standard_normal((b, h, dv)).astype(np.float32)
    got = ops.srf_decode(*(torch.from_numpy(a) for a in (s, z, pq, pk, v)))
    for use_pallas in (True, False):
        want = jops.srf_decode(*(jnp.asarray(a) for a in (s, z, pq, pk, v)),
                               use_pallas=use_pallas)
        for gt, wt in zip(got, want):
            np.testing.assert_allclose(gt.numpy(), np.asarray(wt),
                                       rtol=1e-5, atol=1e-6)


def test_cpu_route_leaves_launch_counters_at_zero():
    ops.reset_counts()
    params, x = _inputs("toeplitz", seed=3)
    ops.spinner_project("toeplitz", {k: torch.from_numpy(v)
                                     for k, v in params.items()},
                        torch.from_numpy(x), M, grouped=True)
    ops.srf_decode(torch.zeros(1, 1, 4, 2), torch.ones(1, 1, 4),
                   torch.ones(1, 1, 4), torch.ones(1, 1, 4),
                   torch.ones(1, 1, 2))
    pool = torch.zeros(3, 2, 4, dtype=torch.int8)
    tables = torch.zeros(1, 2, dtype=torch.long)
    ops.paged_gather(pool, tables)
    ops.paged_gather_dequant(pool, torch.ones(3, 2, 1), tables)
    ops.spinner_project_seeded("toeplitz", torch.tensor([3, 4]),
                               torch.from_numpy(x), M, grouped=True)
    ops.spinner_project_seeded("ldr", 5, torch.from_numpy(x[0]), M)
    ops.fwht(torch.from_numpy(x[0]))
    ops.fwht(torch.ones(2, 2 * kfwht.MAX_N))
    ops.circulant_project(torch.ones(2, N), torch.from_numpy(x[0]), M, "exp",
                          torch.ones(B))
    assert ops.launch_counts() == {"spinner": 0, "srf_decode": 0,
                                   "paged_gather": 0,
                                   "paged_gather_dequant": 0,
                                   "spinner_seeded": 0,
                                   "spinner_plain_on_cuda": 0,
                                   "spinner_seeded_plain_on_cuda": 0,
                                   "fwht": 0, "fwht_plain_on_cuda": 0,
                                   "circulant_project": 0}


def test_kernel_wrappers_refuse_cpu_tensors():
    params, x = _inputs("circulant")
    tp = {k: torch.from_numpy(v) for k, v in params.items()}
    with pytest.raises(ValueError, match="CUDA"):
        kspin.spinner_project_cuda("circulant", tp["g"], torch.from_numpy(x),
                                   M, d0=tp["d0"], d1=tp["d1"])
    t = torch.zeros(1, 1, 4, 2)
    with pytest.raises(ValueError, match="CUDA"):
        kdec.srf_decode_cuda(t, t[..., 0], t[..., 0], t[..., 0], t[:, :, 0])
    pool = torch.zeros(3, 2, 4, dtype=torch.int8)
    tables = torch.zeros(1, 2, dtype=torch.long)
    with pytest.raises(ValueError, match="CUDA"):
        kpg.paged_gather_cuda(pool, tables)
    with pytest.raises(ValueError, match="CUDA"):
        kpg.paged_gather_dequant_cuda(pool, torch.ones(3, 2, 1), tables)
    with pytest.raises(ValueError, match="CUDA"):
        kspin.spinner_project_seeded_cuda(
            "circulant", torch.zeros(G, dtype=torch.int64),
            torch.from_numpy(x), M)
    with pytest.raises(ValueError, match="CUDA"):
        kfwht.fwht_cuda(torch.from_numpy(x[0]))
    with pytest.raises(ValueError, match="CUDA"):
        kcirc.circulant_project_cuda(tp["g"][0], torch.from_numpy(x[0]), M)


def test_asking_for_cuda_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from repro_torch.configs import registry
    from repro_torch.models import transformer
    cfg = registry.reduced("qwen3-4b", attn_impl="srf")
    with pytest.raises((RuntimeError, AssertionError)):
        transformer.init(cfg, device="cuda")


# ``repro.kernels`` re-exports a function named paged_gather over the module
jpg = importlib.import_module("repro.kernels.paged_gather")
# and ``repro_torch.kernels`` the op fwht over the CUDA wrapper's module
kfwht = importlib.import_module("repro_torch.kernels.fwht")

# (N, P, D, R, M): the reduced serving shape (2 kv heads x 16), ragged row
# widths (D * itemsize not a multiple of 16) and one-element rows
GATHER_SHAPES = [(9, 8, 32, 4, 8), (7, 3, 13, 3, 5), (11, 5, 7, 4, 3),
                 (4, 2, 1, 5, 2)]
GATHER_DTYPES = {"float32": (jnp.float32, torch.float32),
                 "bfloat16": (jnp.bfloat16, torch.bfloat16),
                 "int8": (jnp.int8, torch.int8)}


def _gather_inputs(shape, dtype, seed=0):
    """A pool as a (jax, torch) pair with equal values, and (R, M) int32
    page ids of which some lie past the last page."""
    n, p, d, r, m = shape
    rng = np.random.default_rng(seed)
    jdt, tdt = GATHER_DTYPES[dtype]
    if dtype == "int8":
        a = rng.integers(-127, 128, (n, p, d)).astype(np.int8)
    else:
        a = np.asarray(jnp.asarray(rng.standard_normal((n, p, d)), jdt)
                       .astype(jnp.float32))
    tables = rng.integers(0, n + 3, (r, m)).astype(np.int32)
    return (jnp.asarray(a, jdt), torch.from_numpy(a.copy()).to(tdt),
            tables)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy() if x.dtype == torch.bfloat16 else x.numpy()
    return np.asarray(x.astype(jnp.float32) if x.dtype == jnp.bfloat16
                      else x)


@pytest.mark.parametrize("dtype", sorted(GATHER_DTYPES))
@pytest.mark.parametrize("shape", GATHER_SHAPES,
                         ids=["x".join(map(str, s)) for s in GATHER_SHAPES])
def test_plain_paged_gather_matches_pallas(shape, dtype):
    """Bit for bit, ids past the last page included (both clamp to N-1)."""
    jpool, pool, tables = _gather_inputs(shape, dtype)
    got = ops.paged_gather(pool, torch.from_numpy(tables))
    want = jpg.paged_gather_pallas(jpool, jnp.asarray(tables),
                                   interpret=True)
    assert got.dtype == pool.dtype and got.shape == want.shape
    np.testing.assert_array_equal(_np(got), _np(want))


@pytest.mark.parametrize("out", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", GATHER_SHAPES,
                         ids=["x".join(map(str, s)) for s in GATHER_SHAPES])
def test_plain_paged_gather_dequant_matches_pallas(shape, out):
    """int8 pages x f32 row scales, cast to ``out``: bit for bit."""
    jpool, pool, tables = _gather_inputs(shape, "int8", seed=1)
    n, p = shape[:2]
    sc = (np.random.default_rng(2).random((n, p, 1)) / 127
          ).astype(np.float32)
    jdt, tdt = GATHER_DTYPES[out]
    got = ops.paged_gather_dequant(pool, torch.from_numpy(sc),
                                   torch.from_numpy(tables), tdt)
    want = jpg.paged_gather_dequant_pallas(jpool, jnp.asarray(sc),
                                           jnp.asarray(tables), jdt,
                                           interpret=True)
    assert got.dtype == tdt and got.shape == want.shape
    np.testing.assert_array_equal(_np(got), _np(want))


def test_plain_paged_gathers_clamp_negative_ids_like_reference_oracle():
    """Negative ids clamp to page 0, the rule of the reference's jnp
    oracle (``repro.kernels.ref``). The Pallas interpreter wraps them
    instead (-1 reads page N-1); the engines never make one."""
    jpool, pool, _ = _gather_inputs(GATHER_SHAPES[1], "float32")
    tables = np.array([[-3, -1, 0, 2, 9]], np.int32)
    got = ops.paged_gather(pool, torch.from_numpy(tables))
    want = jref.paged_gather_ref(jpool, jnp.asarray(tables))
    np.testing.assert_array_equal(_np(got), _np(want))
    q = torch.arange(-4, 4, dtype=torch.int8).reshape(2, 2, 2)
    sc = torch.tensor([[[0.5], [1.0]], [[2.0], [4.0]]])
    t = np.array([[-1, 1, 5]], np.int32)
    got = ops.paged_gather_dequant(q, sc, torch.from_numpy(t))
    want = jref.paged_gather_dequant_ref(jnp.asarray(q.numpy()),
                                         jnp.asarray(sc.numpy()),
                                         jnp.asarray(t))
    np.testing.assert_array_equal(_np(got), _np(want))


# ---------------------------------------------------------------------------
# fwht and circulant_project
# ---------------------------------------------------------------------------

def _tol(dtype, epilogue="identity"):
    """``tests/test_kernels.py:_tol``."""
    if dtype == "bfloat16":
        if epilogue in ("cos_sin", "exp"):
            return dict(rtol=5e-2, atol=1.5e-1)
        return dict(rtol=2e-2, atol=2e-2)
    return dict(rtol=2e-5, atol=2e-5)


DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _pair(a, dtype):
    """A numpy array as (jax, torch) arrays of ``dtype`` with equal values."""
    jdt, tdt = DTYPES[dtype]
    j = jnp.asarray(a, jdt)
    return j, torch.from_numpy(np.array(j.astype(jnp.float32))).to(tdt)


def _f32(a):
    if isinstance(a, torch.Tensor):
        return a.float().numpy()
    return np.array(jnp.asarray(a).astype(jnp.float32))


@pytest.mark.parametrize("normalized", [True, False])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("b,n", [(1, 8), (4, 64), (16, 128), (5, 512),
                                 (300, 32)])
def test_plain_fwht_matches_reference(b, n, dtype, normalized):
    """Against the Pallas kernel in interpret mode and the jnp oracle.
    Unnormalized outputs are compared divided by sqrt(n), so that one
    tolerance holds at every n (values grow as sqrt(n))."""
    x = np.random.default_rng(b * n).standard_normal((b, n))
    jx, tx = _pair(x, dtype)
    got = ops.fwht(tx, normalized)
    assert got.dtype == tx.dtype and got.shape == (b, n)
    s = 1.0 if normalized else n ** -0.5
    for want in (jops.fwht(jx, normalized, use_pallas=True),
                 jref.fwht_ref(jx, normalized)):
        np.testing.assert_allclose(_f32(got) * s, _f32(want) * s,
                                   **_tol(dtype))


CIRC_SHAPES = [(1, 16, 4, 16), (2, 32, 8, 48), (4, 64, 16, 256),
               (1, 128, 300, 128), (2, 256, 7, 512)]


def _circ_inputs(nb, n, b, epilogue, dtype):
    """``tests/test_kernels.py``'s recipe, drawn with numpy."""
    rng = np.random.default_rng(nb * 1000 + n)
    jg, tg = _pair(rng.standard_normal((nb, n)), dtype)
    jx, tx = _pair(rng.standard_normal((b, n)) * 0.3, dtype)
    jsq = tsq = None
    if epilogue == "exp":
        jsq = (0.5 * jnp.sum(jx.astype(jnp.float32) ** 2, -1)).astype(
            DTYPES[dtype][0])
        tsq = torch.from_numpy(_f32(jsq)).to(DTYPES[dtype][1])
    return (jg, jx, jsq), (tg, tx, tsq)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("epilogue", kcirc.EPILOGUES)
@pytest.mark.parametrize("nb,n,b,m", CIRC_SHAPES)
def test_plain_circulant_project_matches_reference(nb, n, b, m, epilogue,
                                                   dtype):
    """Against the Pallas kernel in interpret mode and the jnp oracle; exp
    in log space (it amplifies rounding by |y|); heaviside only where y
    is not within summation-order noise of its step."""
    (jg, jx, jsq), (tg, tx, tsq) = _circ_inputs(nb, n, b, epilogue, dtype)
    got = ops.circulant_project(tg, tx, m, epilogue, tsq)
    assert got.dtype == tx.dtype
    assert got.shape == (b, 2 * m if epilogue == "cos_sin" else m)
    y = _f32(jref.circulant_project_ref(jg.astype(jnp.float32),
                                        jx.astype(jnp.float32), m))
    for want in (jops.circulant_project(jg, jx, m, epilogue, jsq,
                                        use_pallas=True),
                 jref.circulant_project_ref(jg, jx, m, epilogue, jsq)):
        g, w = _f32(got), _f32(want)
        if epilogue == "exp":
            g, w = np.log(g + 1e-9), np.log(w + 1e-9)
        if epilogue == "heaviside":
            g, w = _far_from_step(y, g, w)
        np.testing.assert_allclose(g, w, **_tol(dtype, epilogue))


def test_plain_circulant_project_is_the_structured_circulant():
    """``test_kernels.py:test_kernel_vs_core_structured`` on the port: the
    projection equals ``core.structured``'s block-circulant matvec."""
    from repro_torch.core import structured
    gen = torch.Generator().manual_seed(3)
    params = structured.init(gen, "circulant", 128, 64)
    x = torch.randn((8, 64), generator=gen)
    torch.testing.assert_close(
        ops.circulant_project(params["g"], x, 128),
        structured.matvec("circulant", params, x, 128), rtol=1e-4, atol=1e-4)


def test_dispatchers_check_the_reference_preconditions():
    with pytest.raises(ValueError, match="power-of-two"):
        ops.fwht(torch.ones(2, 12))
    g, x = torch.ones(2, 8), torch.ones(3, 8)
    with pytest.raises(ValueError, match="cover"):
        ops.circulant_project(g, x, 17)
    with pytest.raises(ValueError, match="epilogue"):
        ops.circulant_project(g, x, 16, "sign")
    with pytest.raises(ValueError, match="sq"):
        ops.circulant_project(g, x, 16, "exp")
