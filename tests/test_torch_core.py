"""The port's core (transforms, structured matrices, spinner pipelines,
SRF attention) against ``repro.core`` on the CPU.

Inputs are made with numpy and the reference's params are carried over
as numpy arrays, so both packages compute the same function. Float
results are compared at rtol=1e-4, atol=1e-5 (f32; the two frameworks'
FFTs and matmuls sum in different orders); integer results and configs
must match exactly.
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import spinner as jspinner
from repro.core import srf_attention as jsrf
from repro.core import structured as jstructured
from repro.core import transforms as jtransforms
from repro_torch.core import spinner, srf_attention, structured, transforms

TOL = dict(rtol=1e-4, atol=1e-5)


def _t(a):
    return torch.from_numpy(np.array(a))


def _tree_t(tree):
    return jax.tree.map(lambda a: _t(a), tree)


@pytest.mark.parametrize("n", [1, 2, 16, 64])
def test_transforms_match_reference(n):
    rng = np.random.default_rng(n)
    x = rng.standard_normal((3, n)).astype(np.float32)
    for normalized in (True, False):
        np.testing.assert_allclose(
            transforms.fwht(_t(x), normalized).numpy(),
            np.asarray(jtransforms.fwht(jnp.asarray(x), normalized)), **TOL)
        np.testing.assert_allclose(
            transforms.fwht_kron(_t(x), normalized).numpy(),
            np.asarray(jtransforms.fwht_kron(jnp.asarray(x), normalized)),
            **TOL)
    np.testing.assert_array_equal(transforms.hadamard(n).numpy(),
                                  np.asarray(jtransforms.hadamard(n)))
    assert transforms.kron_factors(n) == jtransforms.kron_factors(n)
    d0, d1 = (np.sign(rng.standard_normal(n)).astype(np.float32)
              for _ in range(2))
    np.testing.assert_allclose(
        transforms.hd_preprocess(_t(x), _t(d0), _t(d1)).numpy(),
        np.asarray(jtransforms.hd_preprocess(jnp.asarray(x), jnp.asarray(d0),
                                             jnp.asarray(d1))), **TOL)
    gen = torch.Generator().manual_seed(0)
    s = transforms.sample_signs(gen, n)
    assert s.shape == (n,) and set(s.tolist()) <= {-1.0, 1.0}


_jmatvec = jax.jit(jstructured.matvec, static_argnums=(0, 3))
_jmaterialize = jax.jit(jstructured.materialize, static_argnums=(0, 2, 3))


@pytest.mark.parametrize("m,n", [(8, 16), (40, 16)])
@pytest.mark.parametrize("kind", jstructured.KINDS)
def test_structured_matches_reference(kind, m, n):
    params = jstructured.init(jax.random.PRNGKey(m), kind, m, n, r=2)
    x = np.random.default_rng(0).standard_normal((4, n)).astype(np.float32)
    tp = _tree_t(params)
    np.testing.assert_allclose(
        structured.matvec(kind, tp, _t(x), m).numpy(),
        np.asarray(_jmatvec(kind, params, jnp.asarray(x), m)), **TOL)
    np.testing.assert_allclose(
        structured.materialize(kind, tp, m, n).numpy(),
        np.asarray(_jmaterialize(kind, params, m, n)), **TOL)
    # the dense oracle and the FFT path agree inside the port too
    np.testing.assert_allclose(
        structured.matvec(kind, tp, _t(x), m).numpy(),
        x @ structured.materialize(kind, tp, m, n).numpy().T, **TOL)
    for fn in ("budget", "storage_floats", "flops_fast"):
        assert getattr(structured, fn)(kind, m, n, 2) == \
            getattr(jstructured, fn)(kind, m, n, 2)
    mine = structured.init(torch.Generator().manual_seed(0), kind, m, n, r=2)
    assert {k: tuple(v.shape) for k, v in mine.items()} == \
        {k: tuple(v.shape) for k, v in params.items()}


@pytest.mark.parametrize("f", ["identity", "exp", "cos_sin", "relu"])
@pytest.mark.parametrize("kind,depth", [("circulant", 1), ("toeplitz", 1),
                                        ("skew_circulant", 3), ("ldr", 2)])
def test_pipeline_apply_matches_reference(kind, depth, f):
    jpipe = jspinner.hd_chain(kind, n=16, m=24, depth=depth, f=f)
    pipe = spinner.hd_chain(kind, n=16, m=24, depth=depth, f=f)
    assert spinner.dumps(pipe) == jspinner.dumps(jpipe)
    params = jpipe.init(jax.random.PRNGKey(depth))
    x = np.random.default_rng(1).standard_normal((5, 16)).astype(np.float32)
    got = pipe.apply(_tree_t(params), _t(x), y_scale=0.5,
                     out_scale=0.25).numpy()
    want = np.asarray(jpipe.apply(params, jnp.asarray(x), y_scale=0.5,
                                  out_scale=0.25))
    np.testing.assert_allclose(got, want, **TOL)
    np.testing.assert_allclose(pipe.materialize(_tree_t(params)).numpy(),
                               np.asarray(jpipe.materialize(params)), **TOL)
    assert (pipe.budget, pipe.storage, pipe.flops, pipe.out_dim) == \
        (jpipe.budget, jpipe.storage, jpipe.flops, jpipe.out_dim)
    mine = pipe.init(torch.Generator().manual_seed(0))
    assert jax.tree.map(lambda a: tuple(a.shape), _tree_t(params)) == \
        jax.tree.map(lambda a: tuple(a.shape), mine)


def test_config_json_round_trip_across_packages():
    jpipe = jspinner.chain([
        jspinner.SpinnerBlock("hankel", 32, 16, scale=0.25),
        jspinner.SpinnerBlock("ldr", 8, 32, r=3, use_hd=True, ldr_nnz=2)],
        f="sign")
    s = jspinner.dumps(jpipe)
    pipe = spinner.loads(s)
    assert spinner.dumps(pipe) == s
    assert jspinner.loads(spinner.dumps(pipe)) == jpipe
    seeded = jspinner.dumps(jspinner.single("circulant", 8, 16, seeded=True))
    with pytest.raises(NotImplementedError, match="seeded"):
        spinner.loads(seeded)
    with pytest.raises(ValueError, match="version"):
        spinner.loads(json.dumps({"version": 2, "f": "identity",
                                  "blocks": []}))


@pytest.mark.parametrize("feature", ["softmax_pos", "trig", "relu"])
def test_srf_attention_matches_reference(feature):
    jcfg = jsrf.SRFConfig(n_features=24, head_dim=16, feature=feature,
                          chunk=4)
    cfg = srf_attention.SRFConfig(n_features=24, head_dim=16,
                                  feature=feature, chunk=4)
    params = jsrf.init(jax.random.PRNGKey(0), jcfg, 2)
    tp = _tree_t(params)
    rng = np.random.default_rng(3)
    q, k, v = (rng.standard_normal((2, 2, 10, 16)).astype(np.float32)
               for _ in range(3))
    phis = {}
    for name, x, is_q in (("q", q, True), ("k", k, False)):
        got = srf_attention.feature_map(cfg, tp, _t(x), is_query=is_q)
        want = jsrf.feature_map(jcfg, params, jnp.asarray(x), is_query=is_q)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
        phis[name] = (got, want)
    (pq, jpq), (pk, jpk) = phis["q"], phis["k"]
    np.testing.assert_allclose(
        srf_attention.attention_causal(cfg, pq, pk, _t(v)).numpy(),
        np.asarray(jsrf.attention_causal(jcfg, jpq, jpk, jnp.asarray(v))),
        **TOL)
    state = srf_attention.prefill_state(pk[:, :, :9], _t(v)[:, :, :9])
    jstate = jsrf.prefill_state(jpk[:, :, :9], jnp.asarray(v)[:, :, :9])
    (s, z), out = srf_attention.decode_step(state, pq[:, :, 9:], pk[:, :, 9:],
                                            _t(v)[:, :, 9:])
    (js, jz), jout = jsrf.decode_step(jstate, jpq[:, :, 9:], jpk[:, :, 9:],
                                      jnp.asarray(v)[:, :, 9:])
    for a, b in ((s, js), (z, jz), (out, jout)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)
