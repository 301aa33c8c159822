"""The port's SSD block (``repro_torch.models.ssm``) against the
reference's ``repro.models.ssm`` on the CPU, reduced mamba2-2.7b (f32).

The reference's params (``ssm_init``) are carried over leaf for leaf, and
the inputs are made with numpy. ``ssm_apply`` in modes "train",
"prefill" and "decode", and ``paged_ssm_step`` over a chunk with tail
padding and then decode steps, must give
the reference's outputs within 1e-5 of the largest (f32: the frameworks
sum in another order) and its states within 1e-5 relative. The
reference's own checks (``tests/test_ssm.py``: the chunked scan equals
the token recurrence, the prefill state equals the recurrence's, the
state does not grow with the sequence) are run on the port.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jregistry
from repro.models import ssm as jS
from repro_torch.configs import registry
from repro_torch.models import ssm as S

# one intra-op thread: the suite's pytest-xdist workers share the
# cores, and oversubscribed OpenMP pools spin against each other
torch.set_num_threads(1)

STATE_RTOL = 1e-5


def _cfgs(**kw):
    return jregistry.reduced("mamba2-2.7b", **kw), \
        registry.reduced("mamba2-2.7b", **kw)


def _params(jcfg):
    jp = jS.ssm_init(jax.random.PRNGKey(0), jcfg, jnp.float32)
    return jp, {k: torch.from_numpy(np.array(v)) for k, v in jp.items()}


def _x(b, l, d, seed=1):
    return np.random.default_rng(seed).standard_normal(
        (b, l, d)).astype(np.float32) * 0.5


def _close(got, want, rtol=1e-5):
    """Outputs: within ``rtol`` of the largest |want|."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=rtol * np.abs(want).max())


def _state_close(got, want):
    _close(got, want, STATE_RTOL)


def _np(t):
    return t.detach().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t)


@pytest.mark.parametrize("l", [8, 16, 19])    # 19: chunk padding
def test_ssm_apply_train_matches_reference(l):
    jcfg, cfg = _cfgs(ssm_chunk=8)
    jp, p = _params(jcfg)
    x = _x(2, l, cfg.d_model)
    want, _ = jS.ssm_apply(jp, jcfg, jnp.asarray(x), "train")
    got = S.ssm_apply(p, cfg, torch.from_numpy(x), "train")
    _close(_np(got), want)


def test_ssm_prefill_and_decode_match_reference():
    """Prefill 19 tokens (chunk 8: padded), then 4 decode steps: outputs
    and the cache (conv tail, f32 state, idx) after every call."""
    jcfg, cfg = _cfgs(ssm_chunk=8)
    jp, p = _params(jcfg)
    x = _x(2, 23, cfg.d_model)
    jcache = jS.init_ssm_cache(jcfg, 2, jnp.float32)
    cache = S.init_ssm_cache(cfg, 2, torch.float32)
    assert cache["ssm"].dtype == torch.float32
    want, jcache = jS.ssm_apply(jp, jcfg, jnp.asarray(x[:, :19]), "prefill",
                                jcache)
    got = S.ssm_apply(p, cfg, torch.from_numpy(x[:, :19]), "prefill", cache)
    _close(_np(got), want)
    for t in range(19, 23):
        w, jcache = jS.ssm_apply(jp, jcfg, jnp.asarray(x[:, t:t + 1]),
                                 "decode", jcache)
        g = S.ssm_apply(p, cfg, torch.from_numpy(x[:, t:t + 1]), "decode",
                        cache)
        _close(_np(g), w)
        assert cache["idx"] == int(jcache["idx"]) == t + 1
        _state_close(_np(cache["ssm"]), jcache["ssm"])
        _close(_np(cache["conv"]), jcache["conv"])


def _naive(p, cfg, x):
    """The token recurrence: decode applied token by token."""
    cache = S.init_ssm_cache(cfg, x.shape[0], torch.float32)
    outs = [S.ssm_apply(p, cfg, x[:, t:t + 1], "decode", cache)
            for t in range(x.shape[1])]
    return torch.cat(outs, dim=1), cache


@pytest.mark.parametrize("l", [8, 16, 19])
def test_chunked_equals_naive(l):
    """tests/test_ssm.py's check on the port (its tolerance)."""
    _, cfg = _cfgs(ssm_chunk=8)
    _, p = _params(_cfgs(ssm_chunk=8)[0])
    x = torch.from_numpy(_x(2, l, cfg.d_model))
    y_chunk = S.ssm_apply(p, cfg, x, "train")
    y_naive, _ = _naive(p, cfg, x)
    np.testing.assert_allclose(_np(y_chunk), _np(y_naive), rtol=2e-3,
                               atol=2e-4)


def test_prefill_state_matches_naive():
    jcfg, cfg = _cfgs(ssm_chunk=8)
    _, p = _params(jcfg)
    x = torch.from_numpy(_x(2, 16, cfg.d_model))
    cache = S.init_ssm_cache(cfg, 2, torch.float32)
    S.ssm_apply(p, cfg, x, "prefill", cache)
    _, naive = _naive(p, cfg, x)
    np.testing.assert_allclose(_np(cache["ssm"]), _np(naive["ssm"]),
                               rtol=2e-3, atol=2e-4)
    np.testing.assert_allclose(_np(cache["conv"]), _np(naive["conv"]),
                               rtol=1e-4, atol=1e-5)


def test_state_is_sequence_free():
    jcfg, cfg = _cfgs()
    _, p = _params(jcfg)
    for l in (8, 64):
        cache = S.init_ssm_cache(cfg, 1, torch.float32)
        S.ssm_apply(p, cfg, torch.from_numpy(_x(1, l, cfg.d_model)),
                    "prefill", cache)
        assert tuple(cache["ssm"].shape) == (1, cfg.ssm_heads, cfg.ssm_state,
                                             cfg.ssm_head_dim)
        assert cache["idx"] == l


def test_causal_conv_carried_tail():
    """``_causal_conv`` from a carried tail equals the conv over the tail
    and x together, cut to x's positions; no tail is a zero tail."""
    rng = np.random.default_rng(5)
    w, b = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
            for s in ((4, 6), (6,)))
    tail, x = (torch.from_numpy(rng.standard_normal((2, n, 6))
                                .astype(np.float32)) for n in (3, 5))
    whole = S._causal_conv(w, b, torch.cat([tail, x], dim=1))[:, 3:]
    torch.testing.assert_close(S._causal_conv(w, b, x, tail=tail), whole)
    assert torch.equal(S._causal_conv(w, b, x),
                       S._causal_conv(w, b, x, tail=torch.zeros(2, 3, 6)))


def _paged_steps(d, seed=2):
    """A chunk of 8 (rows with 8, 5 and 0 valid tokens: row 2 is padding
    on the null slot 0), then 3 decode steps, as numpy."""
    rng = np.random.default_rng(seed)
    lengths = np.array([8, 5, 0])
    steps = [(rng.standard_normal((3, 8, d)).astype(np.float32) * 0.5,
              np.arange(8)[None, :] < lengths[:, None])]
    for _ in range(3):
        steps.append((rng.standard_normal((3, 1, d)).astype(np.float32)
                      * 0.5, (lengths > 0)[:, None]))
    return steps


def test_paged_ssm_step_matches_reference():
    """The reference's token scan against the port's chunked form: live
    rows' outputs, and every slot's conv tail and state but the null
    slot's, after each step. The conv tail is re-gathered from the last
    valid inputs: row 1's 5 valid tokens of 8 must leave the same tail
    as the reference's."""
    jcfg, cfg = _cfgs()
    jp, p = _params(jcfg)
    slots = np.array([1, 3, 0], np.int32)
    jpool = {"conv": jnp.zeros((4, cfg.ssm_conv - 1, S.conv_dim(cfg))),
             "ssm": jnp.zeros((4, cfg.ssm_heads, cfg.ssm_state,
                               cfg.ssm_head_dim))}
    pool = {k: torch.zeros(v.shape) for k, v in jpool.items()}
    for x, qv in _paged_steps(cfg.d_model):
        want, jpool = jS.paged_ssm_step(jp, jcfg, jnp.asarray(x),
                                        jnp.asarray(qv), jpool,
                                        jnp.asarray(slots))
        got = S.paged_ssm_step(p, cfg, torch.from_numpy(x),
                               torch.from_numpy(qv), pool,
                               torch.from_numpy(slots).long())
        live = qv.any(axis=1)
        _close(_np(got)[live], np.asarray(want)[live])
        _state_close(_np(pool["ssm"])[1:], np.asarray(jpool["ssm"])[1:])
        _close(_np(pool["conv"])[1:], np.asarray(jpool["conv"])[1:])


def test_ssm_init_shapes_and_laws():
    """The port's own init: the reference's shapes and dtypes, a leading
    layer axis with one copy per layer, the constant leaves' values."""
    jcfg, cfg = _cfgs()
    jp = jS.ssm_init(jax.random.PRNGKey(0), jcfg, jnp.float32)
    gen = torch.Generator().manual_seed(0)
    p = S.ssm_init(gen, cfg, torch.float32, lead=(3,))
    assert set(p) == set(jp)
    for k, v in jp.items():
        assert tuple(p[k].shape) == (3, *v.shape), k
    np.testing.assert_allclose(_np(p["a_log"][2]), np.asarray(jp["a_log"]),
                               rtol=1e-6)
    p["d_skip"][0] += 1
    assert float(p["d_skip"][1].max()) == 1.0        # layers do not alias
    with pytest.raises(ValueError, match="ssm mode"):
        S.ssm_apply(S.ssm_init(gen, cfg, torch.float32), cfg,
                    torch.zeros(1, 2, cfg.d_model), "paged")
