"""Three signatures of the reference that the port now takes, each held to
the reference on the CPU (reduced configs, f32, the reference's params
carried over with ``convert.params_from_jax``):

* ``launch.steps.make_serve_step(cfg, greedy=..., temperature=...)``:
  both keywords accepted and ignored, the next tokens the argmax, as the
  reference's step gives them.
* ``transformer.decode_step(..., pos3=)`` and
  ``transformer.embed_inputs(..., decode=True)``: a vision decode step
  carries M-RoPE rows (rows that differ, so 1-D RoPE would not pass),
  and a decode batch skips the vision prefix.
* The legacy ``Engine.run(extra_batch=)``: a vision prefix and ``pos3``
  merged into every prefill batch; tokens equal the reference legacy
  engine's given the same ``extra_batch``.
"""
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jregistry
from repro.launch import steps as jsteps
from repro.models import frontends as jF
from repro.models import transformer as jT
from repro.serving import Request as JRequest
from repro_torch import convert
from repro_torch.configs import registry
from repro_torch.launch import steps
from repro_torch.models import transformer as T
from repro_torch.serving import Request

# one intra-op thread: the suite's pytest-xdist workers share the
# cores, and oversubscribed OpenMP pools spin against each other
torch.set_num_threads(1)

RTOL = 1e-4
_MODELS = {}


def models(arch, **kw):
    """Both packages' reduced configs and params (cached)."""
    key = (arch, tuple(sorted(kw.items())))
    if key not in _MODELS:
        jcfg = jregistry.reduced(arch, n_layers=2, **kw)
        cfg = registry.reduced(arch, n_layers=2, **kw)
        jparams = jax.jit(jT.init, static_argnums=1)(jax.random.PRNGKey(0),
                                                     jcfg)
        params = convert.params_from_jax(jax.tree.map(np.asarray, jparams),
                                         cfg, device="cpu")
        _MODELS[key] = (jcfg, jparams, cfg, params)
    return _MODELS[key]


def _np(a):
    return a.detach().float().numpy() if isinstance(a, torch.Tensor) \
        else np.asarray(a.astype(jnp.float32))


def _close(got, want):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=RTOL,
                               atol=RTOL * np.abs(want).max())


@pytest.mark.parametrize("greedy,temperature", [(True, 1.0), (False, 0.7)])
def test_make_serve_step_takes_greedy_and_temperature(greedy, temperature):
    """Both keywords accepted and ignored: the next tokens are the argmax
    of the logits and equal the reference step's, logits within 1e-4."""
    jcfg, jparams, cfg, params = models("qwen3-4b")
    step = steps.make_serve_step(cfg, greedy=greedy, temperature=temperature)
    jstep = jsteps.make_serve_step(jcfg, greedy=greedy,
                                   temperature=temperature)
    prompt = np.array([[5, 9, 2, 7], [1, 3, 3, 8]], np.int32)
    cache = T.init_serve_cache(cfg, 2, 16, device="cpu")
    jcache = jT.init_serve_cache(jcfg, 2, 16)
    _, cache = T.prefill(params, cfg, {"tokens": torch.from_numpy(prompt)},
                         cache)
    _, jcache = jT.prefill(jparams, jcfg, {"tokens": jnp.asarray(prompt)},
                           jcache)
    tok = np.array([[4], [6]], np.int32)
    for _ in range(3):
        nxt, logits, cache = step(params, cache, torch.from_numpy(tok))
        jnxt, jlogits, jcache = jstep(jparams, jcache, jnp.asarray(tok))
        _close(logits, jlogits)
        assert torch.equal(nxt, torch.argmax(logits, -1)[:, None])
        np.testing.assert_array_equal(nxt.numpy(), np.asarray(jnxt))
        tok = np.array(jnxt)


def _vision_batch(cfg, b, lt, seed=0):
    """A prompt batch with a vision prefix of ``cfg.n_vision_tokens``
    patches and a patch-grid ``pos3`` (t, h, w rows apart), then ``lt``
    text tokens counting on from the grid's largest id."""
    rng = np.random.default_rng(seed)
    nv = cfg.n_vision_tokens
    i = np.arange(nv)
    vis = np.stack([np.zeros(nv), i // 4, i % 4]).astype(np.int32)
    start = int(vis.max()) + 1
    txt = np.broadcast_to(start + np.arange(lt, dtype=np.int32), (3, lt))
    pos3 = np.broadcast_to(np.concatenate([vis, txt], 1)[:, None],
                           (3, b, nv + lt)).copy()
    return {"tokens": rng.integers(0, cfg.vocab, (b, lt)).astype(np.int32),
            "vision_emb": rng.standard_normal(
                (b, nv, jF.VISION_FEAT_DIM)).astype(np.float32),
            "pos3": pos3}


def test_embed_inputs_decode_skips_the_vision_prefix():
    """With ``decode=True`` a batch's ``vision_emb`` is not prefixed;
    without it, it is; both equal the reference's within 1e-4."""
    jcfg, jparams, cfg, params = models("qwen2-vl-2b")
    hb = _vision_batch(cfg, 2, 5)
    for decode in (False, True):
        x, _, _, _ = T.embed_inputs(params, cfg, {
            k: torch.from_numpy(v) for k, v in hb.items()}, decode=decode)
        jx, _, _, _ = jT.embed_inputs(jparams, jcfg, {
            k: jnp.asarray(v) for k, v in hb.items()}, decode=decode)
        _close(x, jx)
        assert x.shape[1] == 5 + (0 if decode else cfg.n_vision_tokens)


def test_decode_step_carries_pos3_rows():
    """Prefill with the vision prefix and its patch grid, then 3 decode
    steps each with ``pos3`` rows that differ (t, h, w = p, p + 1, p + 2):
    logits within 1e-4 of the reference's ``decode_step(pos3=)``, and
    apart from the 1-D RoPE step's (the rows reach the attention)."""
    jcfg, jparams, cfg, params = models("qwen2-vl-2b")
    hb = _vision_batch(cfg, 2, 6)
    cache = T.init_serve_cache(cfg, 2, 32, device="cpu")
    jcache = jT.init_serve_cache(jcfg, 2, 32)
    _, cache = T.prefill(params, cfg, {k: torch.from_numpy(v)
                                       for k, v in hb.items()}, cache)
    _, jcache = jT.prefill(jparams, jcfg, {k: jnp.asarray(v)
                                           for k, v in hb.items()}, jcache)
    tok = np.array([[3], [7]], np.int32)
    for t in range(3):
        p = int(hb["pos3"].max()) + 1 + t
        pos3 = np.broadcast_to(np.array([p, p + 1, p + 2], np.int32)
                               [:, None, None], (3, 2, 1)).copy()
        got, cache = T.decode_step(params, cfg, cache, torch.from_numpy(tok),
                                   pos3=torch.from_numpy(pos3))
        flat, _ = jT.decode_step(jparams, jcfg, jcache, jnp.asarray(tok))
        want, jcache = jT.decode_step(jparams, jcfg, jcache, jnp.asarray(tok),
                                      pos3=jnp.asarray(pos3))
        _close(got, want)
        assert not np.allclose(_np(flat), _np(want), atol=1e-3)
        tok = np.array(jnp.argmax(want[:, :, :cfg.vocab], -1), np.int32)


def _legacy_modules():
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        from repro.serving import legacy as jlegacy
        from repro_torch.serving import legacy
    return jlegacy, legacy


@pytest.mark.parametrize("temperature", [0.0, 0.8])
def test_legacy_run_merges_extra_batch(temperature):
    """4 requests of one prompt length, 2 slots, the same ``extra_batch``
    (one vision prefix and its ``pos3``) given to both packages' legacy
    engines: tokens equal, greedy and sampled; and they differ from a run
    without the prefix (the batch reaches every prefill)."""
    jlegacy, legacy = _legacy_modules()
    jcfg, jparams, cfg, params = models("qwen2-vl-2b")
    lt = 7
    extra = _vision_batch(cfg, 1, lt, seed=1)
    del extra["tokens"]
    rng = np.random.default_rng(2)
    prompts = [rng.integers(0, cfg.vocab, lt).astype(np.int32)
               for _ in range(4)]

    def drive(eng, cls, batch):
        for i, p in enumerate(prompts):
            eng.submit(cls(uid=i, prompt=p.copy(), max_new=5,
                           temperature=temperature))
        return {r.uid: list(r.out_tokens) for r in eng.run(batch)}
    eng = legacy.Engine(cfg, params, batch_slots=2, max_len=48, seed=3,
                        device="cpu")
    got = drive(eng, Request, {k: torch.from_numpy(v)
                               for k, v in extra.items()})
    jeng = jlegacy.Engine(jcfg, jparams, batch_slots=2, max_len=48, seed=3)
    want = drive(jeng, JRequest, {k: jnp.asarray(v)
                                  for k, v in extra.items()})
    assert len(got) == 4 and got == want
    plain = legacy.Engine(cfg, params, batch_slots=2, max_len=48, seed=3,
                          device="cpu")
    assert drive(plain, Request, None) != got
