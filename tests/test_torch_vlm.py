"""The vision family (qwen2-vl-2b: M-RoPE and the vision prefix) in the
port against the reference on the CPU: reduced configs (2 layers, f32,
M-RoPE sections (2, 3, 3)), the reference's params carried over with
``convert.params_from_jax``.

* ``layers.apply_m_rope`` at sections (2, 3, 3) and (16, 24, 24) within
  1e-6 of the reference's, on position rows that differ (with equal
  rows M-RoPE is 1-D RoPE, so a port that ignored ``pos3`` would pass
  on the synthetic stream, whose three rows are one ``arange``).
* ``frontends.frontend_apply`` (the patch adapter), the training
  forward, ``loss_fn`` and the gradients of every leaf against
  ``jax.grad``, full and SRF attention, on a batch whose ``pos3`` is a
  patch grid (t, h, w rows apart) followed by text positions: logits
  and loss within 1e-4 of the largest, gradients within 1e-4 of each
  leaf's largest (f32: the frameworks sum in another order).
* Prefill with the vision prefix and ``pos3``, decode after it, and the
  paged step (1-D RoPE: the serving paths carry no ``pos3``, as the
  reference's) against the reference within 1e-4.
* The engines: greedy and sampled tokens of the port's paged engine
  equal its legacy engine's and the reference paged engine's (int8
  pages: greedy, paged against the reference's paged); the serve CLI and
  the training launcher on the reduced config.
"""
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import serving as jserving
from repro.configs import registry as jregistry
from repro.data import synth as jsynth
from repro.launch import steps as jsteps
from repro.models import frontends as jF
from repro.models import layers as jL
from repro.models import transformer as jT
from repro_torch import convert
from repro_torch import tree as tree_lib
from repro_torch.configs import registry
from repro_torch.data import synth
from repro_torch.launch import serve, steps
from repro_torch.launch import train as train_cli
from repro_torch.models import frontends as F
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.optim import adamw
from repro_torch.serving import Engine, PagedConfig, Request, paged_cache

# one intra-op thread: the suite's pytest-xdist workers share the
# cores, and oversubscribed OpenMP pools spin against each other
torch.set_num_threads(1)

ARCH = "qwen2-vl-2b"
RTOL = 1e-4
IMPLS = ["full", "srf"]

_models = {}


def models(attn="full"):
    """Both packages' reduced configs and params (cached)."""
    if attn not in _models:
        jcfg = jregistry.reduced(ARCH, n_layers=2, attn_impl=attn)
        cfg = registry.reduced(ARCH, n_layers=2, attn_impl=attn)
        jparams = jax.jit(jT.init, static_argnums=1)(jax.random.PRNGKey(0),
                                                     jcfg)
        params = convert.params_from_jax(jax.tree.map(np.asarray, jparams),
                                         cfg, device="cpu")
        _models[attn] = (jcfg, jparams, cfg, params)
    return _models[attn]


def _np(a):
    return a.detach().float().numpy() if isinstance(a, torch.Tensor) \
        else np.asarray(a.astype(jnp.float32))


def _close(got, want, rtol=RTOL):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=rtol * np.abs(want).max())


def _patch_pos3(b, nv, lt, grid_w=4):
    """Qwen2-VL positions: a vision prefix of ``nv`` patches on a grid
    ``grid_w`` wide (t 0, h the patch row, w its column), then ``lt`` text
    tokens whose three rows all count on from the grid's largest id."""
    i = np.arange(nv)
    vis = np.stack([np.zeros(nv), i // grid_w, i % grid_w]).astype(np.int32)
    start = int(vis.max()) + 1
    txt = np.broadcast_to(start + np.arange(lt, dtype=np.int32), (3, lt))
    one = np.concatenate([vis, txt], axis=1)                 # (3, nv + lt)
    return np.ascontiguousarray(np.broadcast_to(one[:, None],
                                                (3, b, nv + lt)))


def _batch(cfg, b=2, seq=32, step=0):
    """``synth.full_batch`` (the same bytes in both packages) with its
    ``pos3`` replaced by a patch grid, so its rows differ."""
    hb = synth.full_batch(cfg, b, seq, step)
    want = jsynth.full_batch(cfg, b, seq, step)
    assert hb.keys() == want.keys()
    assert all(np.array_equal(hb[k], want[k]) for k in hb)
    nv = hb["vision_emb"].shape[1]
    hb["pos3"] = _patch_pos3(b, nv, seq - nv)
    assert not np.array_equal(hb["pos3"][0], hb["pos3"][1])
    return hb


@pytest.mark.parametrize("sections,hd", [((2, 3, 3), 16),
                                         ((16, 24, 24), 128)])
def test_apply_m_rope_matches_reference(sections, hd):
    """Within 1e-6 of the largest |x| (f32), rows of ``pos3`` apart; with
    equal rows it is 1-D RoPE, with unequal rows it is not."""
    rng = np.random.default_rng(0)
    b, h, l = 2, 3, 11
    x = rng.standard_normal((b, h, l, hd)).astype(np.float32)
    pos3 = rng.integers(0, 200, (3, b, l)).astype(np.int32)
    got = L.apply_m_rope(torch.from_numpy(x), torch.from_numpy(pos3), 1e6,
                         sections)
    want = jL.apply_m_rope(jnp.asarray(x), jnp.asarray(pos3), 1e6, sections)
    _close(got, want, 1e-6)
    same = np.broadcast_to(pos3[:1], pos3.shape).copy()
    flat = L.apply_rope(torch.from_numpy(x), torch.from_numpy(same[0]), 1e6)
    _close(L.apply_m_rope(torch.from_numpy(x), torch.from_numpy(same), 1e6,
                          sections), flat, 1e-6)
    assert not np.allclose(got.numpy(), flat.numpy(), atol=1e-3)
    with pytest.raises(ValueError, match="sum"):
        L.apply_m_rope(torch.from_numpy(x), torch.from_numpy(pos3), 1e6,
                       (1, 1, 1))


def test_frontend_apply_matches_reference():
    """The patch adapter: (B, T, 1176) features -> (B, T, d) within 1e-5
    of the reference's; ``feat_dim`` gives both stub widths."""
    jcfg, jparams, cfg, params = models()
    feats = np.random.default_rng(1).standard_normal(
        (2, 5, F.VISION_FEAT_DIM)).astype(np.float32)
    got = F.frontend_apply(params["frontend"], cfg, torch.from_numpy(feats))
    want = jF.frontend_apply(jparams["frontend"], jcfg, jnp.asarray(feats))
    _close(got, want, 1e-5)
    assert (F.AUDIO_FEAT_DIM, F.VISION_FEAT_DIM) == \
        (jF.AUDIO_FEAT_DIM, jF.VISION_FEAT_DIM)
    assert F.feat_dim(cfg) == F.VISION_FEAT_DIM


def test_convert_keeps_layout_and_port_init_matches():
    """The reference's tree carried over leaf for leaf (the adapter
    included), and the port's own init has the same leaves and shapes."""
    for attn in IMPLS:
        jcfg, jparams, cfg, params = models(attn)
        mine = T.init(cfg, seed=0, device="cpu")
        shapes = lambda t: sorted((k, tuple(v.shape))  # noqa: E731
                                  for k, v in tree_lib.leaves_with_path(t))
        assert shapes(params) == shapes(mine)
        assert tuple(params["frontend"]["adapter"].shape) == \
            (F.VISION_FEAT_DIM, cfg.d_model)
        np.testing.assert_array_equal(params["frontend"]["adapter"].numpy(),
                                      np.asarray(jparams["frontend"]
                                                 ["adapter"]))


def _jax_leaves(tree):
    flat = jax.tree_util.tree_flatten_with_path(tree)[0]
    return [np.asarray(v) for _, v in flat]


@pytest.mark.parametrize("attn", IMPLS)
def test_forward_loss_and_gradients_match_reference(attn):
    """A batch of 2 x 32 (a 16-patch prefix on a 4-wide grid, 16 text
    tokens): logits, the loss (the prefix unlabeled) and every float
    leaf's gradient against ``jax.grad`` within 1e-4 of the largest."""
    jcfg, jparams, cfg, params = models(attn)
    hb = _batch(cfg)
    jb = {k: jnp.asarray(v) for k, v in hb.items()}
    tb = {k: torch.from_numpy(v) for k, v in hb.items()}
    jlogits, _ = jax.jit(jT.forward, static_argnums=1)(jparams, jcfg, jb)
    p = T.requires_grad(tree_lib.map(lambda t: t.clone(), params))
    logits, _ = T.forward(p, cfg, tb)
    _close(logits, jlogits)
    (jloss, _), jg = jax.jit(jax.value_and_grad(
        lambda pp: jT.loss_fn(pp, jcfg, jb), has_aux=True))(jparams)
    loss, _ = T.loss_fn(p, cfg, tb)
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=1e-5)
    floats = [t for t in tree_lib.leaves(p) if t.requires_grad]
    grads = torch.autograd.grad(loss, floats)
    want = [w for w in _jax_leaves(jg) if w.dtype.kind == "f"]
    assert len(grads) == len(want)
    assert float(p["frontend"]["adapter"].abs().max()) > 0
    for g, w in zip(grads, want):
        _close(g, w)
    # the adapter's gradient is nonzero: the prefix reaches the loss
    ai = [i for i, t in enumerate(floats)
          if t is p["frontend"]["adapter"]][0]
    assert float(grads[ai].abs().max()) > 0


def test_pos3_reaches_the_attention():
    """Changing only the h and w rows of the prefix's ``pos3`` changes the
    logits (M-RoPE is live in training), in both packages alike."""
    jcfg, jparams, cfg, params = models()
    hb = _batch(cfg)
    flat = dict(hb, pos3=np.broadcast_to(np.arange(32, dtype=np.int32),
                                         (3, 2, 32)).copy())
    outs = {}
    for name, b in (("grid", hb), ("flat", flat)):
        tb = {k: torch.from_numpy(v) for k, v in b.items()}
        outs[name] = T.forward(params, cfg, tb)[0]
        jl, _ = jT.forward(jparams, jcfg, {k: jnp.asarray(v)
                                           for k, v in b.items()})
        _close(outs[name], jl)
    assert not torch.allclose(outs["grid"], outs["flat"], atol=1e-3)


def test_prefill_decode_match_reference():
    """Prefill of a batch with the vision prefix and ``pos3`` (the cache
    holds prefix + text), then 3 decode steps (1-D RoPE at the next
    position, as the reference's ``decode_step`` without ``pos3``):
    logits within 1e-4 of the reference's."""
    jcfg, jparams, cfg, params = models()
    hb = _batch(cfg, b=2, seq=24)
    del hb["labels"]
    cache = T.init_serve_cache(cfg, 2, 48, device="cpu")
    jcache = jT.init_serve_cache(jcfg, 2, 48)
    got, cache = T.prefill(params, cfg, {k: torch.from_numpy(v)
                                         for k, v in hb.items()}, cache)
    want, jcache = jT.prefill(jparams, jcfg, {k: jnp.asarray(v)
                                              for k, v in hb.items()},
                              jcache)
    _close(got, want)
    assert cache["pos"] == int(jcache["pos"]) == 24
    tok = np.array([[3], [7]], np.int32)
    for _ in range(3):
        got, cache = T.decode_step(params, cfg, cache, torch.from_numpy(tok))
        want, jcache = jT.decode_step(jparams, jcfg, jcache,
                                      jnp.asarray(tok))
        _close(got, want)
        tok = np.array(jnp.argmax(want[:, :, :cfg.vocab], -1), np.int32)


_ref_steps = {}


def _ref_engine(jcfg, jparams, quant=False, **kw):
    """A reference paged engine; engines of one (config, page layout)
    share the first one's jitted step (the reference jits anew per
    engine)."""
    eng = jserving.Engine(jcfg, jparams, paged=jserving.PagedConfig(quant),
                          **kw)
    eng._step = _ref_steps.setdefault((eng.cfg, eng.paged), eng._step)
    return eng


@pytest.mark.parametrize("attn", IMPLS)
def test_paged_step_matches_reference(attn):
    """At a 4-slot engine's geometry, against the step it jits: a chunk
    (rows of c, 5 and c - 3 valid tokens and a padding row) and two
    decode steps; live rows' logits within 1e-4 of the largest."""
    jcfg, jparams, cfg, params = models(attn)
    eng = _ref_engine(jcfg, jparams, batch_slots=4, max_len=64)
    sc, n_slots = eng.sched_cfg, eng.sched.num_slots
    b, c, w = sc.max_batch, sc.prefill_chunk, sc.table_width
    from repro.serving import paged_cache as jcache
    jpools = jcache.init_pools(jcfg, sc.num_pages, sc.page_size,
                               num_slots=n_slots)
    pools = paged_cache.init_pools(cfg, sc.num_pages, sc.page_size,
                                   num_slots=n_slots, device="cpu")
    slots = np.array([1, 3, 4, 0], np.int32)
    tables = np.zeros((b, w), np.int32)
    tables[:-1] = np.arange(1, 1 + (b - 1) * w).reshape(b - 1, w)
    rng = np.random.default_rng(0)
    lengths = np.array([c, 5, c - 3, 0])
    steps_ = [(rng.integers(0, cfg.vocab, (b, c)),
               np.tile(np.arange(c), (b, 1)),
               np.arange(c)[None, :] < lengths[:, None])]
    for t in range(2):
        steps_.append((rng.integers(0, cfg.vocab, (b, 1)),
                       (lengths + t)[:, None], (lengths > 0)[:, None]))
    for tok, pos, qv in steps_:
        tok, pos = tok.astype(np.int32), pos.astype(np.int32)
        want, jpools = eng._step(jparams, jpools, *map(jnp.asarray, (
            tok, pos, qv, tables, slots)))
        got, pools = T.paged_step(params, cfg, pools, torch.from_numpy(tok),
                                  torch.from_numpy(pos).long(),
                                  torch.from_numpy(qv),
                                  torch.from_numpy(tables).long(),
                                  torch.from_numpy(slots).long())
        live = qv.any(axis=1)
        _close(_np(got)[live], _np(want)[live])


def _requests(cls, cfg, n, seed=0, temperature=0.0):
    """test_engine_parity._requests's recipe."""
    rng = np.random.default_rng(seed)
    return [cls(uid=i, prompt=rng.integers(0, cfg.vocab, int(
        rng.integers(2, 20))).astype(np.int32),
        max_new=int(rng.integers(3, 7)), temperature=temperature)
        for i in range(n)]


def _drive(eng, reqs):
    for r in reqs:
        eng.submit(r)
    return {r.uid: list(r.out_tokens) for r in eng.run()}


PARITY = [("full", False, 0.0), ("full", False, 0.8), ("full", True, 0.0),
          ("srf", False, 0.0)]


@pytest.mark.parametrize("attn,quant,temperature", PARITY,
                         ids=["full-greedy", "full-sampled", "int8-greedy",
                              "srf-greedy"])
def test_paged_equals_legacy_equals_reference(attn, quant, temperature):
    """8 mixed-length requests, 4 slots: the port's paged tokens equal
    the reference paged engine's, and (but int8, whose legacy cache
    quantizes per head) the port's legacy engine's."""
    jcfg, jparams, cfg, params = models(attn)
    eng = Engine(cfg, params, batch_slots=4, max_len=64, seed=5,
                 device="cpu", paged=PagedConfig(quant))
    paged = _drive(eng, _requests(Request, cfg, 8, 0, temperature))
    assert len(paged) == 8 and eng.nonfinite_rows == 0
    ref = _ref_engine(jcfg, jparams, quant, batch_slots=4, max_len=64,
                      seed=5)
    assert paged == _drive(ref, _requests(jserving.Request, jcfg, 8, 0,
                                          temperature))
    if not quant:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", DeprecationWarning)
            from repro_torch.serving import legacy
        leg = legacy.Engine(cfg, params, batch_slots=4, max_len=64, seed=5,
                            device="cpu")
        assert _drive(leg, _requests(Request, cfg, 8, 0, temperature)) \
            == paged


def test_train_steps_match_reference():
    """Two steps of ``make_train_step`` (AdamW, warmup-cosine) on the
    synthetic stream's vision batches: losses within 1e-5 of the
    reference's steps from the same params."""
    jcfg, jparams, cfg, params = models()
    hyper = steps.TrainHyper(lr=1e-3, warmup=1, total_steps=4)
    jhyper = jsteps.TrainHyper(lr=1e-3, warmup=1, total_steps=4)
    jstep = jax.jit(jsteps.make_train_step(jcfg, jhyper))
    p = T.requires_grad(tree_lib.map(lambda t: t.clone(), params))
    state, jstate, jp = adamw.init(p), None, jparams
    from repro.optim import adamw as jadamw
    jstate = jadamw.init(jparams)
    fn = steps.make_train_step(cfg, hyper)
    for i in range(2):
        hb = synth.full_batch(cfg, 2, 32, i)
        p, state, m = fn(p, state, i, {k: torch.from_numpy(v)
                                       for k, v in hb.items()})
        jp, jstate, jm = jstep(jp, jstate, i, {k: jnp.asarray(v)
                                               for k, v in hb.items()})
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                                   rtol=1e-5)


CLI = [([], "'family': 'kv'"), (["--attn", "srf"], "'family': 'srf'"),
       (["--legacy"], "engine=legacy")]


@pytest.mark.parametrize("flags,expect", CLI,
                         ids=["".join(f) or "kv" for f, _ in CLI])
def test_cli_serves_reduced_on_cpu(capsys, flags, expect):
    args = ["--arch", ARCH, "--reduced", "--device", "cpu", "--requests",
            "3", "--prompt-len", "20", "--max-new", "4", "--slots", "2"]
    assert serve.main(args + flags) == 0
    out = capsys.readouterr().out
    assert "requests=3 tokens=12" in out and expect in out


def test_train_cli_runs_reduced_on_cpu(tmp_path, capsys):
    """``launch.train --arch qwen2-vl-2b --reduced --device cpu``: two
    steps from the synthetic vision stream, finite losses."""
    assert train_cli.main(["--arch", ARCH, "--reduced", "--device", "cpu",
                           "--steps", "2", "--batch", "2", "--seq", "32",
                           "--ckpt-dir", str(tmp_path)]) == 0
    out = capsys.readouterr().out
    assert "arch=qwen2-vl-2b" in out and '"step": 2' in out
