"""The port's kernel dispatchers against the reference's, on the CPU.

On the CPU ``repro_torch.kernels.ops`` runs the plain PyTorch versions
(``repro_torch.kernels.ref``); they are held here to the reference's
Pallas kernels in interpret mode (``use_pallas=True``) and to its jnp
oracles, on the same inputs made with numpy. Tolerances: spinner
rtol=1e-4, atol=1e-5 (FFT, Kronecker and in-kernel sum orders differ);
srf_decode rtol=1e-5, atol=1e-6. The gradients of both spinner ops
(g, x, d0 and d1; seeded: x) are held to ``jax.grad`` through the
reference's Pallas-forward, reference-backward VJPs in interpret mode
with the same tolerance; the port's kernel-forward autograd Functions
are run here with the kernel swapped for its plain version. In bf16
the plain spinner is held to the Pallas kernel in interpret mode within
one bf16 spacing per element (rtol=2**-7): both compute in f32 and
round once, on write. The plain
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
from repro_torch.kernels import spinner as kspin

# ``repro_torch.kernels`` re-exports the ops ``paged_gather`` and
# ``srf_decode`` over the modules of the same names
kpg = importlib.import_module("repro_torch.kernels.paged_gather")
kdec = importlib.import_module("repro_torch.kernels.srf_decode")

# one intra-op thread: the suite's pytest-xdist workers share the
# cores, and oversubscribed OpenMP pools spin against each other
torch.set_num_threads(1)

KINDS = ("circulant", "skew_circulant", "toeplitz", "hankel", "unstructured",
         "ldr")
EPILOGUES = ("identity", "relu", "heaviside", "sign", "exp", "cos_sin")
G, B, N, M = 2, 5, 16, 24

# the reference's jnp oracles, jitted: each compiles once per shape, dtype
# and static argument instead of dispatching op by op (seconds a call)
_jspinner = jax.jit(jops.spinner_project, static_argnums=(0, 3),
                    static_argnames=("epilogue", "y_scale", "out_scale",
                                     "grouped", "use_pallas"))
_jfwht_ref = jax.jit(jref.fwht_ref, static_argnums=1)
_jcirc_ref = jax.jit(jref.circulant_project_ref, static_argnums=(2, 3))


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
    fn = jops.spinner_project if use_pallas else _jspinner
    return np.asarray(fn(
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


GRAD_CASES = [("circulant", "relu"), ("circulant", "exp"),
              ("circulant", "identity"), ("toeplitz", "cos_sin"),
              ("skew_circulant", "exp"), ("hankel", "relu"),
              ("unstructured", "identity")]


def _torch_grads(y, inputs):
    return torch.autograd.grad(torch.sin(y).sum(), inputs)


@pytest.mark.parametrize("kind,epi", GRAD_CASES)
def test_spinner_grads_match_reference_vjp(kind, epi):
    """d/d(g, x, d0, d1) of sum(sin(y)): the port's plain route against
    ``jax.grad`` through the reference's ``_spinner_pallas_vjp`` (Pallas
    forward in interpret mode, jnp backward)."""
    params, x = _inputs(kind)
    names = ("g", "d0", "d1")

    def jloss(jp, jx):
        return jnp.sum(jnp.sin(jops.spinner_project(
            kind, jp, jx, M, epilogue=epi, y_scale=0.8, out_scale=M ** -0.5,
            grouped=True, use_pallas=True)))
    jgp, jgx = jax.grad(jloss, argnums=(0, 1))(
        {k: jnp.asarray(params[k]) for k in names}, jnp.asarray(x))
    tp = {k: torch.from_numpy(params[k]).requires_grad_() for k in names}
    tx = torch.from_numpy(x).requires_grad_()
    y = ops.spinner_project(kind, tp, tx, M, epilogue=epi, y_scale=0.8,
                            out_scale=M ** -0.5, grouped=True)
    got = _torch_grads(y, [tx] + [tp[k] for k in names])
    for g, w in zip(got, [jgx] + [jgp[k] for k in names]):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-4,
                                   atol=1e-5 * np.abs(w).max())


@pytest.mark.parametrize("kind,epi", GRAD_CASES[:4])
def test_seeded_spinner_grads_match_reference_vjp(kind, epi):
    """d/dx through the reference's ``_spinner_seeded_vjp`` (params
    regenerated from the seeds; the seeds get no cotangent)."""
    _, x = _inputs(kind, seed=4)
    seeds = np.array([5, 2 ** 32 - 3], np.uint32)

    def jloss(jx):
        return jnp.sum(jnp.sin(jops.spinner_project_seeded(
            kind, jnp.asarray(seeds), jx, M, epilogue=epi, y_scale=0.8,
            out_scale=M ** -0.5, grouped=True, use_pallas=True)))
    want = np.asarray(jax.grad(jloss)(jnp.asarray(x)))
    tx = torch.from_numpy(x).requires_grad_()
    y = ops.spinner_project_seeded(kind, torch.from_numpy(
        seeds.astype(np.int64)), tx, M, epilogue=epi, y_scale=0.8,
        out_scale=M ** -0.5, grouped=True)
    got, = _torch_grads(y, [tx])
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4,
                               atol=1e-5 * np.abs(want).max())


def _kernel_as_plain(monkeypatch):
    """Swap both CUDA wrappers for their plain versions (counted), so the
    autograd Functions run on CPU tensors."""
    calls = {"fwd": 0, "seeded_fwd": 0}

    def fwd(kind, g, x, m, d0=None, d1=None, **kw):
        calls["fwd"] += 1
        return ref_mod.spinner_project_ref(kind, g, x, m, d0=d0, d1=d1, **kw)

    def seeded_fwd(kind, seeds, x, m, use_hd=True, **kw):
        calls["seeded_fwd"] += 1
        return ref_mod.spinner_project_seeded_ref(kind, seeds, x, m,
                                                  use_hd=use_hd, **kw)
    from repro_torch.kernels import ref as ref_mod
    monkeypatch.setattr(kspin, "spinner_project_cuda", fwd)
    monkeypatch.setattr(kspin, "spinner_project_seeded_cuda", seeded_fwd)
    return calls


@pytest.mark.parametrize("kind,epi", GRAD_CASES[:3])
def test_kernel_functions_backward_is_the_plain_vjp(monkeypatch, kind, epi):
    """The kernel-forward autograd Functions with the kernel swapped for
    its plain version: their gradients equal the plain route's (bit for
    bit: the backward IS the plain version's VJP), the forward runs once
    a call, the backward is counted apart, and only what requires grad
    gets a gradient."""
    calls = _kernel_as_plain(monkeypatch)
    ops.reset_counts()
    params, x = _inputs(kind, seed=2)
    kw = dict(epilogue=epi, y_scale=0.8, out_scale=M ** -0.5)
    tp = [torch.from_numpy(params[k]).requires_grad_()
          for k in ("g", "d0", "d1")]
    tx = torch.from_numpy(x).requires_grad_()
    y = ops._SpinnerKernel.apply(tp[0], tx, tp[1], tp[2], kind, M,
                                 *kw.values())
    got = _torch_grads(y, [tx] + tp)
    want = _torch_grads(ops.spinner_project(
        kind, dict(zip(("g", "d0", "d1"), tp)), tx, M, grouped=True, **kw),
        [tx] + tp)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    y = ops._SpinnerKernel.apply(tp[0].detach(), tx, None, None, kind, M,
                                 *kw.values())
    gx, = _torch_grads(y, [tx])
    assert gx.shape == tx.shape
    seeds = torch.tensor([7, 9])
    ys = ops._SeededSpinnerKernel.apply(seeds, tx, kind, M, 1, 4, True,
                                        *kw.values())
    gs, = _torch_grads(ys, [tx])
    ws, = _torch_grads(ops.spinner_project_seeded(kind, seeds, tx, M,
                                                  grouped=True, **kw), [tx])
    assert torch.equal(gs, ws)
    assert calls == {"fwd": 2, "seeded_fwd": 1}
    counts = ops.launch_counts()
    assert counts["spinner_bwd"] == 2 and counts["spinner_seeded_bwd"] == 1


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
    ops.paged_gather_dequant_kv(pool, torch.ones(3, 2, 1), pool,
                                torch.ones(3, 2, 1), tables)
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
                                   "paged_gather_dequant_kv": 0,
                                   "spinner_seeded": 0,
                                   "spinner_plain_on_cuda": 0,
                                   "spinner_seeded_plain_on_cuda": 0,
                                   "spinner_bwd": 0,
                                   "spinner_seeded_bwd": 0,
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
        kpg.paged_gather_dequant_kv_cuda(pool, torch.ones(3, 2, 1), pool,
                                         torch.ones(3, 2, 1), tables)
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
                 _jfwht_ref(jx, normalized)):
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
    y = _f32(_jcirc_ref(jg.astype(jnp.float32), jx.astype(jnp.float32),
                        m))
    for want in (jops.circulant_project(jg, jx, m, epilogue, jsq,
                                        use_pallas=True),
                 _jcirc_ref(jg, jx, m, epilogue, jsq)):
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


# (nb, n, m): window tiles only (n = 1024), none (n < BN), both (n = 200,
# 256 + 128 = 384, 1000: tiles that cross a generator block next to
# windows), n not a multiple of BK, m not a multiple of BN.
B_TILE_SHAPES = [(1, 16, 16), (3, 40, 120), (4, 64, 256), (2, 200, 330),
                 (2, 384, 700), (1, 1000, 1000), (4, 1024, 4096)]


def _check_b_tiles(tile_of, dense, kind, n, m):
    """Every (chunk, column tile) operand ``tile_of(i0, j0)`` equals the
    dense A where both indices are in range, and a built tile is zero past
    them (``kernels.window``, the rule of ``csrc/window_mma.cuh``).
    Returns the number of column tiles read as a window."""
    from repro_torch.kernels import window
    windows = 0
    for i0 in range(0, m, window.BN):
        built = window.layout(kind, n, i0) == "built"
        windows += not built
        for j0 in range(0, n, window.BK):
            tile = tile_of(i0, j0)
            assert tile.shape == (window.BK, window.BN)
            cols, rows = min(window.BN, m - i0), min(window.BK, n - j0)
            assert torch.equal(tile[:rows, :cols],
                               dense[i0:i0 + cols, j0:j0 + rows].T), \
                (kind, n, m, i0, j0)
            if built:
                assert not tile[rows:].any() and not tile[:, cols:].any()
    return windows


@pytest.mark.parametrize("nb,n,m", B_TILE_SHAPES)
def test_circulant_b_tile_matches_circulant_matrix(nb, n, m):
    """The circulant kernel's index rules (``circulant.b_tile``: the
    shared rule of ``kernels.window``, the Toeplitz window and the per-row
    rule): every A[i, j] of every (chunk, column tile) equals
    ``ref.circulant_matrix``; the window is taken exactly where a tile
    lies in one generator block."""
    from repro_torch.kernels import ref
    g = torch.from_numpy(np.random.default_rng(n).standard_normal(
        (nb, n)).astype(np.float32))
    for i0 in range(0, m, kcirc.BN):
        assert kcirc.window_ok(n, i0) == \
            (i0 // n == (i0 + kcirc.BN - 1) // n)
    windows = _check_b_tiles(lambda i0, j0: kcirc.b_tile(g, m, i0, j0),
                             ref.circulant_matrix(g, m), "circulant", n, m)
    assert (windows > 0) == (n >= kcirc.BN)


# (n, m) for every spinner kind: n < BK (12), n < BN with m crossing
# generator blocks (40, 64), n not a multiple of BK (40, 70, 200), tiles
# crossing a block next to windows (160, 200), m not a multiple of BN,
# and the pre-pass widths (256, 1024) with m > n.
SPIN_TILE_SHAPES = [(12, 36), (40, 120), (64, 200), (70, 140), (160, 400),
                    (200, 330), (256, 384), (1024, 1300)]


@pytest.mark.parametrize("n,m", SPIN_TILE_SHAPES)
@pytest.mark.parametrize("kind", kspin.KERNEL_KINDS)
def test_spinner_b_tile_matches_materialize(kind, n, m):
    """Both spinner kernels' B operand rules (``spinner.b_tile``: Toeplitz
    and Hankel windows, built tiles for circulant / skew tiles across a
    block and for dense A) give ``structured.materialize`` at every
    (chunk, column tile); windows exactly where ``window.layout`` says,
    and a built tile reserved exactly where one is built
    (``window.crosses_block``)."""
    from repro_torch.core import structured
    from repro_torch.kernels import seedgen
    g = seedgen.seeded_params(kind, n, m, 11, use_hd=False)["g"]
    dense = structured.materialize(kind, {"g": g}, m, n)
    windows = _check_b_tiles(lambda i0, j0: kspin.b_tile(kind, g, m, i0, j0),
                             dense, kind, n, m)
    from repro_torch.kernels import window
    tiles = -(-m // window.BN)
    if kind in ("toeplitz", "hankel"):
        assert windows == tiles
    elif kind == "unstructured" or n < window.BN:
        assert windows == 0
    else:
        assert 0 < windows
    if kind in ("circulant", "skew_circulant"):
        # the launch reserves a built tile's shared memory by this rule
        assert window.crosses_block(n, m) == (windows < tiles)


@pytest.mark.parametrize("n,m", SPIN_TILE_SHAPES)
@pytest.mark.parametrize("kind", kspin.KERNEL_KINDS)
def test_seeded_b_tile_draw_positions(kind, n, m):
    """The seeded kernel draws each generator value a column tile reads
    once (``window.seeded_positions``: whole generator blocks, or the
    BN + n - 1 Toeplitz / Hankel diagonals) and builds its operand from
    them: equal, bit for bit, to the materialized kernel's operand on
    ``seedgen.grouped_params`` of the same seed, padding included; the
    drawn positions lie in the canonical generator array."""
    from repro_torch.kernels import seedgen, window
    seed = 5 + n
    g = seedgen.grouped_params(kind, n, m, torch.tensor([seed]),
                               use_hd=False)["g"][0]
    for i0 in range(0, m, window.BN):
        base, pos = window.seeded_positions(kind, n, m, i0)
        assert pos.numel() == 0 or (0 <= int(pos.min())
                                    and int(pos.max()) < g.numel())
        for j0 in range(0, n, window.BK):
            assert torch.equal(kspin.seeded_b_tile(kind, seed, n, m, i0, j0),
                               kspin.b_tile(kind, g, m, i0, j0)), \
                (kind, n, m, i0, j0)


@pytest.mark.parametrize("n,use_hd,epilogue,dtype,want", [
    (128, True, "exp", torch.float32, (False, False)),
    (128, False, "identity", torch.bfloat16, (False, False)),
    (256, True, "identity", torch.float32, (True, False)),
    (1024, True, "exp", torch.bfloat16, (True, True)),
    (160, False, "exp", torch.float32, (False, True)),
    (160, False, "identity", torch.bfloat16, (True, False))])
def test_spinner_scratch_rule(n, use_hd, epilogue, dtype, want):
    """The pre-pass's scratch (z, 0.5||x||^2) exactly above n = 128: z
    with HD or for bf16 x (the mainloop's A operand is f32), the norms
    for exp."""
    assert kspin.scratch(n, use_hd, epilogue, dtype) == want


def test_build_hash_covers_included_headers(tmp_path, monkeypatch):
    """``build.lib_path`` hashes a source and the ``csrc/`` headers it
    includes: editing the shared header renames both libraries that
    include it (spinner, circulant) and no other (no nvcc needed)."""
    import shutil
    from repro_torch.kernels import build
    csrc = tmp_path / "csrc"
    shutil.copytree(build.CSRC, csrc)
    monkeypatch.setattr(build, "CSRC", csrc)
    names = ("spinner", "circulant", "fwht", "srf_decode", "paged_gather")
    before = {name: build.lib_path(name) for name in names}
    assert [p.name for p in build.sources("spinner")] == [
        "spinner.cu", "window_mma.cuh"]
    header = csrc / "window_mma.cuh"
    header.write_bytes(header.read_bytes() + b"\n// edited\n")
    after = {name: build.lib_path(name) for name in names}
    assert {name for name in names if after[name] != before[name]} == {
        "spinner", "circulant"}
