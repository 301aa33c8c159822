"""The port's kernel-estimation library (estimators, coherence, the pmodel
shim, the live quality probe) against the reference on the CPU.

Inputs are made with numpy from a seed, and the reference's params are
carried over as numpy arrays, so both packages compute the same
function. Tolerances: closed forms 1e-6 (f32 arithmetic in both);
``estimate`` rtol 1e-4, atol 1e-6 (the two frameworks' FFTs sum in
different orders); coherence chi and the two booleans exact, mu and mu~
within 1e-5; probe stats within 1e-5. Torch and jax draw different
numbers, so ``mc_error`` and the unbiasedness of Lemma 5 are held to
the closed forms statistically, as the reference's own tests hold it.
"""
import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jregistry
from repro.core import coherence as jcoherence
from repro.core import estimators as jestimators
from repro.core import features as jfeatures
from repro.core import spinner as jspinner
from repro.core import structured as jstructured
from repro.core import transforms as jtransforms
from repro.models import transformer as jT
from repro.obs import quality as jquality
from repro_torch import convert
from repro_torch.configs import registry
from repro_torch.core import (coherence, estimators, features, pmodel,
                              spinner, transforms)
from repro_torch.obs import quality

# one intra-op thread: the suite's pytest-xdist workers share the
# cores, and oversubscribed OpenMP pools spin against each other
torch.set_num_threads(1)

FNAMES = ("identity", "heaviside", "sign", "relu", "trig", "softmax")


def _t(a):
    return torch.from_numpy(np.array(a))


def _tree_t(tree):
    return jax.tree.map(_t, tree)


def _unit_pairs(n, count, seed=0):
    """``count`` pairs of unit vectors (f32), drawn with numpy."""
    rng = np.random.default_rng(seed)
    v = rng.standard_normal((2, count, n))
    v /= np.linalg.norm(v, axis=-1, keepdims=True)
    return v[0].astype(np.float32), v[1].astype(np.float32)


# ---------------------------------------------------------------------------
# transforms and features
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", [1, 5, 8, 100])
def test_pad_pow2_matches_reference(n):
    x = np.random.default_rng(n).standard_normal((3, n)).astype(np.float32)
    assert transforms.next_pow2(n) == jtransforms.next_pow2(n)
    np.testing.assert_array_equal(transforms.pad_pow2(_t(x)).numpy(),
                                  np.asarray(jtransforms.pad_pow2(
                                      jnp.asarray(x))))


def test_phi_softmax_trig_matches_reference():
    jpipe = jspinner.single("circulant", m=48, n=16)
    pipe = spinner.single("circulant", m=48, n=16)
    params = jpipe.init(jax.random.PRNGKey(0))
    x = np.random.default_rng(1).standard_normal((5, 16)).astype(np.float32)
    got = features.phi_softmax_trig(pipe, _tree_t(params), _t(x), scale=0.5)
    want = jfeatures.phi_softmax_trig(jpipe, params, jnp.asarray(x),
                                      scale=0.5)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-6)


# ---------------------------------------------------------------------------
# estimators
# ---------------------------------------------------------------------------

def test_closed_forms_match_reference():
    v1, v2 = _unit_pairs(32, 6)
    v2 = 0.7 * v2            # unequal norms for relu / trig
    for fname in FNAMES:
        np.testing.assert_allclose(
            estimators.exact(fname, _t(v1), _t(v2), 0.8).numpy(),
            np.asarray(jestimators.exact(fname, jnp.asarray(v1),
                                         jnp.asarray(v2), 0.8)),
            rtol=1e-6, atol=1e-6)
    for name in ("k_angular_paper", "angle"):
        np.testing.assert_allclose(
            getattr(estimators, name)(_t(v1), _t(v2)).numpy(),
            np.asarray(getattr(jestimators, name)(jnp.asarray(v1),
                                                  jnp.asarray(v2))),
            rtol=1e-6, atol=1e-6)
    assert set(estimators.EXACT) == set(jestimators.EXACT)


@pytest.mark.parametrize("fname", FNAMES)
@pytest.mark.parametrize("make", ["single", "hd_chain"])
def test_estimate_matches_reference(make, fname):
    """Every f, on params carried over from the reference's init."""
    n, m = 64, 256
    jpipe = getattr(jspinner, make)("circulant", m=m, n=n)
    pipe = getattr(spinner, make)("circulant", m=m, n=n)
    params = jpipe.init(jax.random.PRNGKey(7))
    v1, v2 = _unit_pairs(n, 8, seed=1)
    got = estimators.estimate(pipe, _tree_t(params), fname, _t(v1), _t(v2),
                              sigma=0.9)
    want = jestimators.estimate(jpipe, params, fname, jnp.asarray(v1),
                                jnp.asarray(v2), sigma=0.9)
    assert got.shape == (8,)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-6)


@pytest.mark.filterwarnings("ignore:repro.core.pmodel:DeprecationWarning")
@pytest.mark.filterwarnings(
    "ignore:passing \\w+ here is deprecated:DeprecationWarning")
def test_pmodel_shim_matches_reference():
    """The legacy ``PModelSpec`` path: ``estimate`` through the shim (under
    its DeprecationWarning), and the shim's project / project_fused /
    materialize / moments, against the reference's shim on the same
    params (the reference's own warnings are silenced here, as its
    shim tests do)."""
    from repro.core import pmodel as jpmodel
    jspec = jpmodel.PModelSpec(kind="toeplitz", m=48, n=32)
    spec = pmodel.PModelSpec(kind="toeplitz", m=48, n=32)
    p = jpmodel.init(jax.random.PRNGKey(3), jspec)
    tp = _tree_t(p)
    v1, v2 = _unit_pairs(32, 4, seed=2)
    with pytest.warns(DeprecationWarning, match="passing PModelSpec here"):
        got = estimators.estimate(spec, tp, "relu", _t(v1), _t(v2))
    want = jestimators.estimate(jspec, p, "relu", jnp.asarray(v1),
                                jnp.asarray(v2))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-6)
    x = _t(v1)
    with pytest.warns(DeprecationWarning, match="pmodel.project is"):
        y = pmodel.project(spec, tp, x)
    np.testing.assert_allclose(y.numpy(), np.asarray(jpmodel.project(
        jspec, p, jnp.asarray(v1))), rtol=1e-4, atol=1e-5)
    with pytest.warns(DeprecationWarning, match="pmodel.project_fused"):
        y = pmodel.project_fused(spec, tp, x, epilogue="exp", out_scale=0.5)
    np.testing.assert_allclose(y.numpy(), np.asarray(jpmodel.project_fused(
        jspec, p, jnp.asarray(v1), epilogue="exp", out_scale=0.5)),
        rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(pmodel.materialize(spec, tp).numpy(),
                               np.asarray(jpmodel.materialize(jspec, p)),
                               rtol=1e-4, atol=1e-5)
    for a, b in zip(pmodel.row_gaussianity_moments(spec, tp),
                    jpmodel.row_gaussianity_moments(jspec, p)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                   atol=1e-6)
    with pytest.warns(DeprecationWarning, match="pmodel.init is"):
        mine = pmodel.init(torch.Generator().manual_seed(0), spec)
    assert {k: tuple(v.shape) for k, v in mine.items()} == \
        {k: tuple(v.shape) for k, v in p.items()}
    assert (spec.budget, spec.storage) == (jspec.budget, jspec.storage)
    with pytest.raises(TypeError):
        estimators.estimate(object(), tp, "relu", x, x)


@pytest.mark.parametrize("kind", ["circulant", "toeplitz"])
def test_error_decreases_with_m(kind):
    """``test_estimators.py:test_error_decreases_with_m`` on the port
    (Thm 11/12: the estimation error concentrates as m grows)."""
    n = 64
    v1, v2 = (_t(v[0]) for v in _unit_pairs(n, 1, seed=4))
    errs = []
    for m in [16, 256]:
        gen = torch.Generator().manual_seed(3)
        mean, std = estimators.mc_error(gen, spinner.single(kind, m=m, n=n),
                                        "heaviside", v1, v2, n_trials=48)
        assert mean.shape == std.shape == ()
        errs.append(float(mean))
    assert errs[1] < errs[0], errs


@pytest.mark.parametrize("kind", ["circulant", "toeplitz", "hankel"])
@pytest.mark.parametrize("fname", ["identity", "heaviside", "sign", "relu"])
def test_unbiasedness_lemma5(kind, fname):
    """``test_estimators.py:test_unbiasedness_lemma5`` on the port: the
    mean over P-model draws of the structured estimate is the closed
    form, within 4 standard errors (or 0.02)."""
    n, m, trials = 32, 32, 600
    pipe = spinner.single(kind, m=m, n=n)
    v1, w = _unit_pairs(n, 1, seed=5)
    v1, w = torch.from_numpy(v1[0]), torch.from_numpy(w[0])
    v2 = 0.6 * v1 + 0.8 * w
    v2 = v2 / torch.linalg.norm(v2)
    gen = torch.Generator().manual_seed(3)
    ests = torch.stack([estimators.estimate(pipe, pipe.init(gen), fname,
                                            v1, v2) for _ in range(trials)])
    exact = float(estimators.exact(fname, v1, v2))
    se = float(ests.std()) / math.sqrt(trials)
    assert abs(float(ests.mean()) - exact) < max(4 * se, 0.02), \
        (fname, float(ests.mean()), exact)


# ---------------------------------------------------------------------------
# coherence
# ---------------------------------------------------------------------------

STAT_KEYS = ("chi", "mu", "mu_tilde", "normalized", "orthogonal_cols",
             "budget_t")


def _assert_stats_equal(got, want):
    assert set(got) == set(want) == set(STAT_KEYS)
    for k in ("chi", "normalized", "orthogonal_cols", "budget_t"):
        assert got[k] == want[k], (k, got, want)
    for k in ("mu", "mu_tilde"):
        assert got[k] == pytest.approx(want[k], abs=1e-5), (k, got, want)


@pytest.mark.parametrize("kind,chi_max", [("circulant", 3), ("toeplitz", 2),
                                          ("hankel", 2)])
def test_pmodel_stats_match_reference(kind, chi_max):
    m, n = 6, 8
    p = jstructured.init(jax.random.PRNGKey(0), kind, m, n)
    got = coherence.pmodel_stats(kind, _tree_t(p), m, n)
    _assert_stats_equal(got, jcoherence.pmodel_stats(kind, p, m, n))
    # the paper's Sec 2.2 values (ANALYTIC), as the reference test holds
    assert got["chi"] <= chi_max == coherence.ANALYTIC[kind]["chi_max"]
    assert got["mu_tilde"] == pytest.approx(0.0, abs=1e-5)
    assert coherence.ANALYTIC == jcoherence.ANALYTIC


def test_pipeline_stats_match_reference():
    jpipe = jspinner.hd_chain("toeplitz", n=8, m=6, depth=2)
    pipe = spinner.hd_chain("toeplitz", n=8, m=6, depth=2)
    params = jpipe.init(jax.random.PRNGKey(1))
    got = coherence.pipeline_stats(pipe, _tree_t(params))
    want = jcoherence.pipeline_stats(jpipe, params)
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        _assert_stats_equal(g, w)
    np.testing.assert_allclose(
        coherence.sigma_tensor(coherence.p_matrices(
            "toeplitz", _tree_t(params[1]), 6, 8)),
        jcoherence.sigma_tensor(jcoherence.p_matrices(
            "toeplitz", params[1], 6, 8)), atol=1e-6)


# ---------------------------------------------------------------------------
# the live quality probe
# ---------------------------------------------------------------------------

def _seeded(cfg):
    return dataclasses.replace(cfg, srf=dataclasses.replace(cfg.srf,
                                                            seeded=True))


@pytest.mark.parametrize("seeded", [False, True])
def test_srf_quality_probe_matches_reference(seeded):
    jcfg = jregistry.reduced("qwen3-4b", n_layers=2, attn_impl="srf")
    cfg = registry.reduced("qwen3-4b", n_layers=2, attn_impl="srf")
    if seeded:
        jcfg, cfg = _seeded(jcfg), _seeded(cfg)
    jparams = jT.init(jax.random.PRNGKey(0), jcfg)
    params = convert.params_from_jax(jax.tree.map(np.asarray, jparams), cfg,
                                     device="cpu")
    for layer, head in ((0, 0), (1, 1)):
        got = quality.srf_quality_probe(cfg, params, layer=layer, head=head)
        want = jquality.srf_quality_probe(jcfg, jparams, layer=layer,
                                          head=head)
        assert set(got) == set(want) == {"srf_row_mean_abs_max",
                                         "srf_row_var_err_max"}
        for k in got:
            assert isinstance(got[k], float)
            assert got[k] == pytest.approx(float(want[k]), abs=1e-5), k
    if not seeded:          # the reference's full report: a seed has no
        full = quality.srf_quality_probe(cfg, params, full=True)  # jacobian
        jfull = jquality.srf_quality_probe(jcfg, jparams, full=True)
        assert set(full) == set(jfull)
        for k in full:
            assert full[k] == pytest.approx(float(jfull[k]), abs=1e-5), k
    kv = registry.reduced("qwen3-4b", n_layers=2)
    from repro_torch.models import transformer
    assert quality.srf_quality_probe(
        kv, transformer.init(kv, seed=0, device="cpu")) is None


def test_moments_drifted():
    assert quality.DRIFT_TOL == jquality.DRIFT_TOL
    assert not quality.moments_drifted(None)
    assert not quality.moments_drifted({})
    ok = {"srf_row_mean_abs_max": 0.1, "srf_row_var_err_max": 0.2}
    assert not quality.moments_drifted(ok)
    assert quality.moments_drifted(dict(ok, srf_row_mean_abs_max=0.6))
    assert quality.moments_drifted(dict(ok, srf_row_var_err_max=0.51))
    assert quality.moments_drifted(ok, tol=0.15)
    for stats in (ok, dict(ok, srf_row_var_err_max=0.7)):
        assert quality.moments_drifted(stats) == \
            jquality.moments_drifted(stats)
