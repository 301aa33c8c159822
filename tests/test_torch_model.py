"""The port's paged model step against ``repro.models.transformer`` on the
CPU: reduced qwen3-4b with SRF attention, the reference's params carried
over with ``convert.params_from_jax``. One chunked-prefill step and four
batched decode steps must give the same logits (rtol=1e-3, atol=1e-4,
f32: the frameworks' matmuls, FFTs and exp sum and round differently,
and the error grows through the layers) and the same SRF slot states.

The same steps in bf16 (the full-width dtype: bf16 weights, activations
and state pools) are held to the reference with its Pallas kernels in
interpret mode, i.e. the TPU kernels' numerics.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jregistry
from repro.models import attention as jA
from repro.models import transformer as jT
from repro.serving import paged_cache as jcache
from repro_torch import convert
from repro_torch.configs import registry
from repro_torch.models import attention as A
from repro_torch.models import transformer as T
from repro_torch.serving import paged_cache

TOL = dict(rtol=1e-3, atol=1e-4)


@pytest.fixture(scope="module")
def models():
    jcfg = jregistry.reduced("qwen3-4b", attn_impl="srf")
    cfg = registry.reduced("qwen3-4b", attn_impl="srf")
    jparams = jT.init(jax.random.PRNGKey(0), jcfg)
    params = convert.params_from_jax(jax.tree.map(np.asarray, jparams), cfg,
                                     device="cpu")
    return jcfg, jparams, cfg, params


def test_convert_keeps_layout_and_values(models):
    jcfg, jparams, cfg, params = models
    jl = jax.tree_util.tree_leaves_with_path(jparams)
    tl = jax.tree_util.tree_leaves_with_path(
        jax.tree.map(lambda t: t.numpy(), params))
    assert [p for p, _ in jl] == [p for p, _ in tl]
    for (_, a), (_, b) in zip(jl, tl):
        np.testing.assert_array_equal(np.asarray(a), b)
    mine = T.init(cfg, seed=0, device="cpu")
    assert jax.tree.map(lambda t: tuple(t.shape), mine) == \
        jax.tree.map(lambda t: tuple(t.shape), params)
    with pytest.raises(ValueError, match="keys"):
        convert.params_from_jax({"embed": {}}, cfg, device="cpu")


def _steps(vocab, seed=0):
    """One chunked-prefill step (rows of 8, 5 and 0 valid tokens; row 2 is
    padding on the null slot 0) and four decode steps, as numpy."""
    rng = np.random.default_rng(seed)
    b, c = 3, 8
    lengths = np.array([8, 5, 0])
    tokens = rng.integers(0, vocab, (b, c)).astype(np.int32)
    pos = np.tile(np.arange(c, dtype=np.int32), (b, 1))
    qv = np.arange(c)[None, :] < lengths[:, None]
    steps = [(tokens, pos, qv)]
    for t in range(4):
        tok = rng.integers(0, vocab, (b, 1)).astype(np.int32)
        steps.append((tok, (lengths + t)[:, None].astype(np.int32),
                      (lengths > 0)[:, None]))
    return steps


SLOTS = np.array([1, 3, 0], np.int32)
TABLES = np.zeros((3, 1), np.int32)


def _run_jax(jparams, jcfg, steps):
    """-> (live logit rows of every step as f32 numpy, final pools)."""
    pools, out = jcache.init_pools(jcfg, 2, 16, num_slots=4), []
    for tok, p, v in steps:
        logits, pools = jT.paged_step(jparams, jcfg, pools, jnp.asarray(tok),
                                      jnp.asarray(p), jnp.asarray(v),
                                      jnp.asarray(TABLES), jnp.asarray(SLOTS))
        out.append(np.asarray(logits.astype(jnp.float32))[v.any(axis=1)])
    return out, pools


def _run_port(params, cfg, steps):
    pools, out = paged_cache.init_pools(cfg, 2, 16, num_slots=4,
                                        device="cpu"), []
    for tok, p, v in steps:
        logits, pools = T.paged_step(params, cfg, pools,
                                     torch.from_numpy(tok),
                                     torch.from_numpy(p),
                                     torch.from_numpy(v),
                                     torch.from_numpy(TABLES),
                                     torch.from_numpy(SLOTS))
        out.append(logits.float().numpy()[v.any(axis=1)])
    return out, pools


def _state(pools, key):
    """Live slots 1 and 3 of the SRF pool, as f32 numpy."""
    a = pools["slot"][0]["attn"][key][:, [1, 3]]
    return (a.float().numpy() if isinstance(a, torch.Tensor)
            else np.asarray(a.astype(jnp.float32)))


def test_paged_step_logits_match_reference(models):
    jcfg, jparams, cfg, params = models
    steps = _steps(cfg.vocab)
    want, jpools = _run_jax(jparams, jcfg, steps)
    got, pools = _run_port(params, cfg, steps)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_allclose(g, w, **TOL)
    for key in ("s", "z"):
        np.testing.assert_allclose(_state(pools, key), _state(jpools, key),
                                   **TOL)


def test_paged_step_bf16_matches_reference_kernels(monkeypatch):
    """bf16 logits and state within 2e-2 of their largest magnitude (the
    bf16 tolerance of ``chip_smoke.py``). Both sides round every matmul,
    the logits and the pools to bf16, in different places, so they part
    by a few bf16 spacings: 1.3e-2 at most over seeds 0-2, while the
    reference's bf16 run parts from its f32 run at the same weights by up
    to 2.0e-2. A second check: the port's bf16 run is no farther from
    that f32 run than the reference's bf16 run is (RMS over the logits;
    ratio 0.93-0.99 measured), so no cast of the port adds error of its
    own. The sharp bf16 check is per kernel, in test_torch_kernels."""
    monkeypatch.setenv("REPRO_FORCE_PALLAS", "interpret")
    jcfg = jregistry.reduced("qwen3-4b", attn_impl="srf", dtype="bfloat16")
    cfg = registry.reduced("qwen3-4b", attn_impl="srf", dtype="bfloat16")
    jparams = jT.init(jax.random.PRNGKey(0), jcfg)
    params = convert.params_from_jax(jax.tree.map(np.asarray, jparams), cfg,
                                     device="cpu")
    assert params["embed"]["tok"].dtype == torch.bfloat16
    steps = _steps(cfg.vocab)
    want, jpools = _run_jax(jparams, jcfg, steps)
    got, pools = _run_port(params, cfg, steps)
    assert pools["slot"][0]["attn"]["s"].dtype == torch.bfloat16

    def close(g, w):
        assert g.shape == w.shape and np.isfinite(g).all()
        np.testing.assert_allclose(g, w, rtol=0,
                                   atol=2e-2 * np.abs(w).max())
    for g, w in zip(got, want):
        close(g, w)
    for key in ("s", "z"):
        close(_state(pools, key), _state(jpools, key))

    f32 = lambda t: t.astype(jnp.float32) \
        if jnp.issubdtype(t.dtype, jnp.floating) else t        # noqa: E731
    exact, _ = _run_jax(jax.tree.map(f32, jparams),
                        jregistry.reduced("qwen3-4b", attn_impl="srf"), steps)
    rms = lambda a, b: float(np.sqrt(np.mean(                  # noqa: E731
        np.square(np.concatenate([x.ravel() for x in a])
                  - np.concatenate([x.ravel() for x in b])))))
    assert rms(got, exact) <= 1.25 * rms(want, exact)


@pytest.mark.parametrize("c", [1, 8])
def test_paged_srf_bf16_matches_reference_kernels(monkeypatch, c):
    """One bf16 state pool through ``_paged_srf``: decode (C=1, the
    srf_decode kernel on f32 copies of the rows, one cast back) and a
    chunk (C=8, bf16 einsums). The updated pool rows match the reference
    bit for bit; so does the decode output. The chunk output rounds its
    bf16 einsums in other places and parts by at most two bf16 spacings
    (rtol=2**-6; 1.3e-2 at most over seeds 0-3)."""
    monkeypatch.setenv("REPRO_FORCE_PALLAS", "interpret")
    rng = np.random.default_rng(0)
    n, h, m, dv, b = 4, 4, 32, 16, 3
    s = rng.standard_normal((n, h, m, dv)) * 4
    z = rng.random((n, h, m)) * 16
    pq, pk = (rng.random((b, h, c, m)) / 4 for _ in range(2))
    v = rng.standard_normal((b, h, c, dv))
    qv = np.arange(c)[None, :] < np.array([c, max(c - 3, 1), 0])[:, None]
    slots = np.array([1, 3, 0], np.int32)            # row 2: padding
    J = lambda a: jnp.asarray(a, jnp.bfloat16)              # noqa: E731
    P = lambda a: torch.from_numpy(np.array(                 # noqa: E731
        J(a).astype(jnp.float32))).bfloat16()
    jout, jpool = jA._paged_srf(None, {"s": J(s), "z": J(z)},
                                jnp.asarray(slots), J(pq), J(pk), J(v),
                                jnp.asarray(qv))
    pool = {"s": P(s), "z": P(z)}
    out = A._paged_srf(pool, torch.from_numpy(slots).long(), P(pq), P(pk),
                       P(v), torch.from_numpy(qv))
    assert out.dtype == pool["s"].dtype == torch.bfloat16
    f32 = lambda a: np.asarray(a.astype(jnp.float32))       # noqa: E731
    for key in ("s", "z"):                 # slot 0 is the null slot
        np.testing.assert_array_equal(pool[key].float().numpy()[1:],
                                      f32(jpool[key])[1:])
    live = qv.any(axis=1)
    got, want = out.float().numpy()[live], f32(jout)[live]
    if c == 1:
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=2 ** -6,
                                   atol=2 ** -8 * np.abs(want).max())


def test_other_families_raise_not_implemented():
    for arch, over in (("qwen3-4b", {}), ("deepseek-v2-lite-16b",
                                         {"attn_impl": "srf"}),
                       ("mamba2-2.7b", {})):
        cfg = registry.reduced(arch, **over)
        with pytest.raises(NotImplementedError):
            paged_cache.plan_for(cfg)
