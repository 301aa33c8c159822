"""The port's kernel dispatchers against the reference's, on the CPU.

On the CPU ``repro_torch.kernels.ops`` runs the plain PyTorch versions
(``repro_torch.kernels.ref``); they are held here to the reference's
Pallas kernels in interpret mode (``use_pallas=True``) and to its jnp
oracles, on the same inputs made with numpy. Tolerances: spinner
rtol=1e-4, atol=1e-5 (FFT, Kronecker and in-kernel sum orders differ);
srf_decode rtol=1e-5, atol=1e-6. In bf16 the plain spinner is held to
the Pallas kernel in interpret mode within one bf16 spacing per element
(rtol=2**-7): both compute in f32 and round once, on write. The CUDA
kernels themselves run only on the card: ``tests/test_torch_cuda.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import structured as jstructured
from repro.kernels import ops as jops
from repro_torch.kernels import ops
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
    assert ops.launch_counts() == {"spinner": 0, "srf_decode": 0,
                                   "spinner_plain_on_cuda": 0}


def test_kernel_wrappers_refuse_cpu_tensors():
    params, x = _inputs("circulant")
    tp = {k: torch.from_numpy(v) for k, v in params.items()}
    with pytest.raises(ValueError, match="CUDA"):
        kspin.spinner_project_cuda("circulant", tp["g"], torch.from_numpy(x),
                                   M, d0=tp["d0"], d1=tp["d1"])
    t = torch.zeros(1, 1, 4, 2)
    with pytest.raises(ValueError, match="CUDA"):
        kdec.srf_decode_cuda(t, t[..., 0], t[..., 0], t[..., 0], t[:, :, 0])


def test_asking_for_cuda_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from repro_torch.configs import registry
    from repro_torch.models import transformer
    cfg = registry.reduced("qwen3-4b", attn_impl="srf")
    with pytest.raises((RuntimeError, AssertionError)):
        transformer.init(cfg, device="cuda")
