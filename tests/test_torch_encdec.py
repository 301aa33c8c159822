"""The enc-dec family (seamless-m4t-large-v2: the encoder, cross
attention and the encoder-memory pool) in the port against the reference
on the CPU: reduced configs (2 decoder and 2 encoder layers, f32,
enc_len 16), the reference's params carried over with
``convert.params_from_jax``.

* Integers and bytes exactly: ``synthetic_audio_features`` draws the
  reference's bytes, ``engine._enc_namespace`` and ``_cache_namespace``
  give the reference's integers, the pool plans ("kv+mem", "srf+mem")
  and their bytes a token are the reference's.
* Floats within 1e-4 of the largest (f32; the frameworks sum in another
  order): ``frontend_apply`` (1e-5), ``encode_memory`` (full and SRF:
  ``srf_attention.attention_noncausal``), ``cross_attention`` and
  ``paged_cross_attention``, the training forward, ``loss_fn`` and every
  gradient against ``jax.grad``, prefill and decode with the memory, and
  the paged step against a memory pool (full KV, int8 pages, SRF).
* The engines on 8 mixed requests with distinct features: the port's
  paged tokens equal the reference paged engine's and its legacy
  engine's, greedy and sampled; seeded SRF with embed seeds; and the
  reference's own enc-dec cells (``tests/test_engine_parity.py``,
  ``tests/test_prefix_serving.py``): 16 concurrent paged == legacy, a
  reused slot's memory and state rewritten, the prefix matrix's five
  scenarios with the reference's counters, equal features sharing the
  trie and other features partitioning it; preemption restores the
  memory row. Two training steps equal the reference's, and the serve
  and training CLIs run the reduced config on the CPU.
"""
import dataclasses
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import serving as jserving
from repro.configs import registry as jregistry
from repro.launch import steps as jsteps
from repro.models import attention as jA
from repro.models import frontends as jF
from repro.models import transformer as jT
from repro.serving import engine as jengine
from repro.serving import paged_cache as jcache
from repro_torch import convert
from repro_torch import tree as tree_lib
from repro_torch.configs import registry
from repro_torch.launch import serve, steps
from repro_torch.models import attention as A
from repro_torch.models import frontends as F
from repro_torch.models import transformer as T
from repro_torch.serving import (ChunkConfig, Engine, PagedConfig,
                                 PrefixConfig, Request, SchedConfig,
                                 paged_cache)
from repro_torch.serving import engine as engine_lib

# one intra-op thread: the suite's pytest-xdist workers share the
# cores, and oversubscribed OpenMP pools spin against each other
torch.set_num_threads(1)

ARCH = "seamless-m4t-large-v2"
RTOL = 1e-4
IMPLS = ["full", "srf"]

_models = {}


def _seeded(cfg):
    return dataclasses.replace(cfg, srf=dataclasses.replace(cfg.srf,
                                                            seeded=True))


def models(attn="full", seeded=False):
    """Both packages' reduced configs and params (cached)."""
    key = (attn, seeded)
    if key not in _models:
        jcfg = jregistry.reduced(ARCH, n_layers=2, attn_impl=attn)
        cfg = registry.reduced(ARCH, n_layers=2, attn_impl=attn)
        if seeded:
            jcfg, cfg = _seeded(jcfg), _seeded(cfg)
        jparams = jax.jit(jT.init, static_argnums=1)(jax.random.PRNGKey(0),
                                                     jcfg)
        params = convert.params_from_jax(jax.tree.map(np.asarray, jparams),
                                         cfg, device="cpu")
        _models[key] = (jcfg, jparams, cfg, params)
    return _models[key]


def _np(a):
    return a.detach().float().numpy() if isinstance(a, torch.Tensor) \
        else np.asarray(a.astype(jnp.float32))


def _close(got, want, rtol=RTOL):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=rtol * np.abs(want).max())


def _feats(cfg, n, seed=1):
    rng = np.random.default_rng(seed)
    return np.stack([F.synthetic_audio_features(rng, cfg) for _ in range(n)])


# ---------------------------------------------------------------------------
# integers and bytes
# ---------------------------------------------------------------------------

def test_features_and_namespaces_bit_equal():
    """The same bytes from the same generator; the namespace is the
    reference's integer (blake2b of the C-contiguous f32 bytes), a
    Fortran-ordered copy of the same features included; tenants and
    seeded SRF's embed seeds fold in as the reference folds them."""
    cfg, jcfg = registry.reduced(ARCH), jregistry.reduced(ARCH)
    for seed in (0, 7):
        a = F.synthetic_audio_features(np.random.default_rng(seed), cfg)
        b = jF.synthetic_audio_features(np.random.default_rng(seed), jcfg)
        assert a.dtype == b.dtype == np.float32 and a.tobytes() == b.tobytes()
        assert a.shape == (cfg.enc_len, F.AUDIO_FEAT_DIM)
        assert engine_lib._enc_namespace(a) == jengine._enc_namespace(b)
        assert engine_lib._enc_namespace(np.asfortranarray(a)) == \
            jengine._enc_namespace(b)
        for tenant, es in (("", 0), ("acme", 0), ("acme", 99)):
            r = Request(uid=0, prompt=np.ones(2, np.int32), enc_emb=a,
                        namespace=tenant, embed_seed=es)
            jr = jserving.Request(uid=0, prompt=np.ones(2, np.int32),
                                  enc_emb=b, namespace=tenant, embed_seed=es)
            for seeded in (False, True):
                assert engine_lib._cache_namespace(r, seeded) == \
                    jengine._cache_namespace(jr, seeded)
    other = F.synthetic_audio_features(np.random.default_rng(1), cfg)
    assert engine_lib._enc_namespace(other) != engine_lib._enc_namespace(a)


def test_plans_and_bytes_per_token_match_reference():
    """"kv+mem" and "srf+mem" (reduced and full width, int8 or not): the
    names, ``has_memory``, ``needs_slot`` and the bytes a token (the
    memory slot amortized over max_len) equal the reference's; the pool
    container carries one contiguous (num_slots, enc_len, d) memory."""
    for attn in IMPLS:
        for full in (False, True):
            cfg = (registry.get if full else registry.reduced)(
                ARCH, attn_impl=attn)
            jcfg = (jregistry.get if full else jregistry.reduced)(
                ARCH, attn_impl=attn)
            plan, jplan = paged_cache.plan_for(cfg), jcache.plan_for(jcfg)
            assert (plan.name, plan.has_memory, plan.needs_slot) == \
                (jplan.name, jplan.has_memory, jplan.needs_slot) == \
                (f"{'srf' if attn == 'srf' else 'kv'}+mem", True, True)
            for q in (False, True):
                assert plan.bytes_per_token(cfg, 256, PagedConfig(q)) == \
                    jplan.bytes_per_token(jcfg, 256,
                                          jcache.PagedConfig(q))
    cfg = registry.reduced(ARCH)
    pools = paged_cache.init_pools(cfg, 9, 8, num_slots=3, device="cpu")
    mem = pools["memory"]
    assert mem.shape == (3, cfg.enc_len, cfg.d_model) and mem.is_contiguous()
    assert paged_cache.memory_bytes(pools) == mem.numel() * 4
    assert paged_cache.pool_bytes(pools) == paged_cache.memory_bytes(pools) \
        + 2 * 2 * 9 * 8 * cfg.kv_dim * 4


def test_snapshot_zero_and_restore_carry_the_memory_row():
    """A slot's memory row goes into the snapshot, ``zero_slot_rows``
    clears it (or leaves it with ``zero_memory=False``), and the restore
    writes it back into another slot, the pool contiguous throughout."""
    cfg = registry.reduced(ARCH)
    pools = paged_cache.init_pools(cfg, 9, 8, num_slots=4, device="cpu")
    mem = pools["memory"]
    mem.copy_(torch.randn(mem.shape, generator=torch.Generator()
                          .manual_seed(0)))
    row = mem[2].clone()
    snap = paged_cache.snapshot_page_rows_async(pools, [3], [2])
    paged_cache.zero_slot_rows(pools, [2], zero_memory=False)
    assert torch.equal(mem[2], row)
    paged_cache.zero_slot_rows(pools, [2])
    assert not mem[2].any()
    assert snap.nbytes == row.numel() * 4 + 2 * 8 * cfg.kv_dim * 4 * 2
    paged_cache.restore_page_rows(pools, [5], [3], snap)
    assert torch.equal(mem[3], row) and mem.is_contiguous()
    host = paged_cache.pool_page_rows(pools, [5], [3])
    assert torch.equal(host["memory"][0], row)


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------

def test_convert_keeps_layout_and_port_init_matches():
    """The reference's tree carried over leaf for leaf (the adapter, the
    stacked encoder, enc_norm, each decoder layer's cross attention and
    ln_x), and the port's own init has the same leaves and shapes."""
    for attn in IMPLS:
        jcfg, jparams, cfg, params = models(attn)
        mine = T.init(cfg, seed=0, device="cpu")
        shapes = lambda t: sorted((k, tuple(v.shape))  # noqa: E731
                                  for k, v in tree_lib.leaves_with_path(t))
        assert shapes(params) == shapes(mine)
        assert params["encoder"]["ln1"]["w"].shape[0] == cfg.enc_layers
        for leaf in (("frontend", "adapter"), ("enc_norm", "w")):
            np.testing.assert_array_equal(
                params[leaf[0]][leaf[1]].numpy(),
                np.asarray(jparams[leaf[0]][leaf[1]]))
        seg, jseg = params["segments"][0], jparams["segments"][0]
        for k in ("wq", "wk", "wv", "wo"):
            np.testing.assert_array_equal(seg["cross"][k].numpy(),
                                          np.asarray(jseg["cross"][k]))
        np.testing.assert_array_equal(seg["ln_x"]["w"].numpy(),
                                      np.asarray(jseg["ln_x"]["w"]))
    bad = jax.tree.map(np.asarray, models()[1])
    del bad["enc_norm"]
    with pytest.raises(ValueError, match="keys"):
        convert.params_from_jax(bad, models()[2], device="cpu")


def test_frontend_apply_matches_reference():
    jcfg, jparams, cfg, params = models()
    x = _feats(cfg, 2)
    _close(F.frontend_apply(params["frontend"], cfg, torch.from_numpy(x)),
           jF.frontend_apply(jparams["frontend"], jcfg, jnp.asarray(x)), 1e-5)


@pytest.mark.parametrize("attn", IMPLS)
def test_encode_memory_matches_reference(attn):
    """The encoder over 2 requests' features (bidirectional softmax, or
    SRF's ``attention_noncausal``) and the encode step, batch 1 as the
    engine runs it."""
    jcfg, jparams, cfg, params = models(attn)
    x = _feats(cfg, 2)
    want = jax.jit(jT.encode_memory, static_argnums=1)(jparams, jcfg,
                                                       jnp.asarray(x))
    _close(T.encode_memory(params, cfg, torch.from_numpy(x)), want)
    enc = steps.make_encode_step(cfg)
    jenc = jsteps.make_encode_step(jcfg)
    _close(enc(params, torch.from_numpy(x[:1])),
           jenc(jparams, jnp.asarray(x[:1])))


def test_attention_noncausal_matches_reference():
    from repro.core import srf_attention as jsrf
    from repro_torch.core import srf_attention as srf
    rng = np.random.default_rng(0)
    pq, pk = (np.abs(rng.standard_normal((2, 3, 9, 8))).astype(np.float32)
              for _ in range(2))
    v = rng.standard_normal((2, 3, 9, 5)).astype(np.float32)
    _close(srf.attention_noncausal(*map(torch.from_numpy, (pq, pk, v))),
           jsrf.attention_noncausal(*map(jnp.asarray, (pq, pk, v))), 1e-5)


def test_cross_attention_matches_reference():
    """``cross_attention`` and ``paged_cross_attention`` of 5 decoder rows
    over a 16-row memory, one layer's params."""
    jcfg, jparams, cfg, params = models()
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 5, cfg.d_model)).astype(np.float32)
    mem = rng.standard_normal((2, cfg.enc_len, cfg.d_model)).astype(
        np.float32)
    p = {k: v[0] for k, v in params["segments"][0]["cross"].items()}
    jp = {k: v[0] for k, v in jparams["segments"][0]["cross"].items()}
    want = jA.cross_attention(jp, jcfg, jnp.asarray(x), jnp.asarray(mem))
    tx, tm = torch.from_numpy(x), torch.from_numpy(mem)
    _close(A.cross_attention(p, cfg, tx, tm), want)
    _close(A.paged_cross_attention(p, cfg, tx, tm),
           jA.paged_cross_attention(jp, jcfg, jnp.asarray(x),
                                    jnp.asarray(mem)))


def _jax_leaves(tree):
    return [np.asarray(v) for _, v in
            jax.tree_util.tree_flatten_with_path(tree)[0]]


@pytest.mark.parametrize("attn", IMPLS)
def test_forward_loss_and_gradients_match_reference(attn):
    """``synth.full_batch``'s enc-dec batch (2 x 24 tokens, 2 x 16 x 160
    features): logits, loss and every float leaf's gradient (the
    encoder's, the cross attention's and the adapter's included) against
    ``jax.grad``."""
    from repro_torch.data import synth
    jcfg, jparams, cfg, params = models(attn)
    hb = synth.full_batch(cfg, 2, 24, 0)
    jb = {k: jnp.asarray(v) for k, v in hb.items()}
    tb = {k: torch.from_numpy(v) for k, v in hb.items()}
    p = T.requires_grad(tree_lib.map(lambda t: t.clone(), params))
    logits, _ = T.forward(p, cfg, tb)
    _close(logits, jax.jit(jT.forward, static_argnums=1)(jparams, jcfg,
                                                         jb)[0])
    (jloss, _), jg = jax.jit(jax.value_and_grad(
        lambda pp: jT.loss_fn(pp, jcfg, jb), has_aux=True))(jparams)
    loss, _ = T.loss_fn(p, cfg, tb)
    np.testing.assert_allclose(float(loss.detach()), float(jloss),
                               rtol=1e-5)
    floats = [t for t in tree_lib.leaves(p) if t.requires_grad]
    grads = torch.autograd.grad(loss, floats)
    want = [w for w in _jax_leaves(jg) if w.dtype.kind == "f"]
    assert len(grads) == len(want)
    for g, w in zip(grads, want):
        _close(g, w)
    named = dict(zip(map(id, floats), grads))
    for leaf in (p["encoder"]["attn"]["wq"], p["segments"][0]["cross"]["wk"],
                 p["frontend"]["adapter"]):
        assert float(named[id(leaf)].abs().max()) > 0


@pytest.mark.parametrize("attn", IMPLS)
def test_prefill_decode_match_reference(attn):
    """The legacy engine's model calls: prefill of 2 requests with their
    features (the cache stores the memory), then 3 decode steps."""
    jcfg, jparams, cfg, params = models(attn)
    rng = np.random.default_rng(4)
    tok = rng.integers(0, cfg.vocab, (2, 9)).astype(np.int32)
    x = _feats(cfg, 2)
    cache = T.init_serve_cache(cfg, 2, 32, device="cpu")
    jc = jT.init_serve_cache(jcfg, 2, 32)
    got, cache = T.prefill(params, cfg, {"tokens": torch.from_numpy(tok),
                                         "enc_emb": torch.from_numpy(x)},
                           cache)
    want, jc = jT.prefill(jparams, jcfg, {"tokens": jnp.asarray(tok),
                                          "enc_emb": jnp.asarray(x)}, jc)
    _close(got, want)
    _close(cache["memory"], jc["memory"])
    nxt = np.array([[1], [2]], np.int32)
    for _ in range(3):
        got, cache = T.decode_step(params, cfg, cache, torch.from_numpy(nxt))
        want, jc = jT.decode_step(jparams, jcfg, jc, jnp.asarray(nxt))
        _close(got, want)
        nxt = np.array(jnp.argmax(want[:, :, :cfg.vocab], -1), np.int32)


_ref_steps = {}


def _ref_engine(jcfg, jparams, quant=False, **kw):
    """A reference paged engine. The reference jits its step and its
    encode step anew per engine; engines of one (config, page layout)
    share the first one's (the same functions), which keep their
    compiled shapes."""
    eng = jserving.Engine(jcfg, jparams, paged=jserving.PagedConfig(quant),
                          **kw)
    eng._step = _ref_steps.setdefault((eng.cfg, eng.paged), eng._step)
    eng._encode = _ref_steps.setdefault(eng.cfg, eng._encode)
    return eng


CELLS = {"full KV": ("full", False), "int8 pages": ("full", True),
         "SRF": ("srf", False)}


@pytest.mark.parametrize("cell", list(CELLS))
def test_paged_step_with_memory_matches_reference(cell):
    """At a 4-slot engine's geometry, against the step it jits: the
    memory pool holds 3 requests' encoded memories (slots 1, 3, 4; slot 0
    the null slot of the padding row); a chunk and two decode steps; the
    live rows' logits within 1e-4 of the largest, the memory pool passed
    through unchanged."""
    attn, quant = CELLS[cell]
    jcfg, jparams, cfg, params = models(attn)
    eng = _ref_engine(jcfg, jparams, quant, batch_slots=4, max_len=64)
    sc, n_slots = eng.sched_cfg, eng.sched.num_slots
    b, c, w = sc.max_batch, sc.prefill_chunk, sc.table_width
    jpools = jcache.init_pools(jcfg, sc.num_pages, sc.page_size,
                               num_slots=n_slots,
                               paged=jcache.PagedConfig(quant))
    pools = paged_cache.init_pools(cfg, sc.num_pages, sc.page_size,
                                   num_slots=n_slots, device="cpu",
                                   paged=PagedConfig(quant))
    slots = np.array([1, 3, 4, 0], np.int32)
    feats = _feats(cfg, 3)
    jmem = jT.encode_memory(jparams, jcfg, jnp.asarray(feats))
    jpools["memory"] = jpools["memory"].at[jnp.asarray(slots[:3])].set(jmem)
    pools["memory"][torch.from_numpy(slots[:3]).long()] = \
        T.encode_memory(params, cfg, torch.from_numpy(feats))
    before = pools["memory"].clone()
    tables = np.zeros((b, w), np.int32)
    if eng.plan.has_paged:
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
    assert torch.equal(pools["memory"], before)
    _close(pools["memory"], jpools["memory"])


# ---------------------------------------------------------------------------
# the engines
# ---------------------------------------------------------------------------

def _requests(cls, cfg, n, seed=0, temperature=0.0, embed=False):
    """test_engine_parity._requests's recipe: each request's features,
    then its prompt, from one generator; ``embed``: a non-zero embed
    seed on all but every third request, and every odd request sampled
    at ``temperature`` 0.8 (the rest greedy)."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        enc = F.synthetic_audio_features(rng, cfg)
        out.append(cls(uid=i, prompt=rng.integers(0, cfg.vocab, int(
            rng.integers(2, 20))).astype(np.int32),
            max_new=int(rng.integers(3, 7)),
            temperature=0.8 if embed and i % 2 else temperature,
            enc_emb=enc, embed_seed=(1000 * i + 7) if embed and i % 3
            else 0))
    return out


def _drive(eng, reqs):
    for r in reqs:
        eng.submit(r)
    done = eng.run()
    for r in done:
        assert r.t_submit <= r.t_first <= r.t_done
        if r.trace is not None:
            assert r.trace.monotonic() and r.trace.count("done") == 1
    return {r.uid: list(r.out_tokens) for r in done}


def _legacy_engine(cfg, params, **kw):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        from repro_torch.serving import legacy
    return legacy.Engine(cfg, params, device="cpu", **kw)


def _assert_no_leaks(eng):
    sched = eng.sched
    if eng.prefix is not None:
        assert sched.alloc.used_pages == eng.prefix.pages
        eng.prefix.drop_all()
    assert sched.alloc.used_pages == 0 and sched.alloc.total_refs == 0
    assert sched.slot_alloc.used_pages == 0


PARITY = [("full KV", 0.0), ("full KV", 0.8), ("int8 pages", 0.0),
          ("SRF", 0.0)]


@pytest.mark.parametrize("cell,temperature", PARITY,
                         ids=[f"{c}-{'sampled' if t else 'greedy'}"
                              for c, t in PARITY])
def test_paged_equals_legacy_equals_reference(cell, temperature):
    """8 mixed-length requests with distinct features, 4 slots: the
    port's paged tokens equal the reference paged engine's and (but
    int8 pages, which the legacy cache quantizes per head) the port's
    legacy engine's, greedy, and sampled with full KV (SRF is sampled in
    the seeded test below); every page and slot comes back."""
    attn, quant = CELLS[cell]
    jcfg, jparams, cfg, params = models(attn)
    eng = Engine(cfg, params, batch_slots=4, max_len=64, seed=5,
                 device="cpu", paged=PagedConfig(quant))
    paged = _drive(eng, _requests(Request, cfg, 8, 0, temperature))
    assert len(paged) == 8 and eng.nonfinite_rows == 0
    ref = _ref_engine(jcfg, jparams, quant, batch_slots=4, max_len=64,
                      seed=5)
    assert paged == _drive(ref, _requests(jserving.Request, jcfg, 8, 0,
                                          temperature))
    _assert_no_leaks(eng)
    if not quant:
        leg = _legacy_engine(cfg, params, batch_slots=4, max_len=64, seed=5)
        assert _drive(leg, _requests(Request, cfg, 8, 0, temperature)) \
            == paged


def test_seeded_srf_with_embed_seeds_matches_reference():
    """Seeded SRF (the encoder's feature maps on the layers' own seeds,
    the decoder's folded with each request's embed seed), greedy and
    sampled requests in one batch: the port's paged tokens equal the
    reference engine's, and the embed seeds change some."""
    jcfg, jparams, cfg, params = models("srf", seeded=True)
    got = _drive(Engine(cfg, params, batch_slots=4, max_len=64, seed=5,
                        device="cpu"), _requests(Request, cfg, 8,
                                                 embed=True))
    want = _drive(_ref_engine(jcfg, jparams, batch_slots=4, max_len=64,
                              seed=5),
                  _requests(jserving.Request, jcfg, 8, embed=True))
    assert len(got) == 8 and got == want
    base = _drive(Engine(cfg, params, batch_slots=4, max_len=64, seed=5,
                         device="cpu"), _requests(Request, cfg, 8))
    assert base != got


def test_encdec_16_concurrent():
    """tests/test_engine_parity.py:146, the enc-dec case: 16 concurrent
    requests through 8 slots equal the legacy engine's greedy tokens;
    every page and slot comes back."""
    _, _, cfg, params = models()
    eng = Engine(cfg, params, batch_slots=8, max_len=64, device="cpu")
    paged = _drive(eng, _requests(Request, cfg, 16, seed=3))
    leg = _legacy_engine(cfg, params, batch_slots=8, max_len=64)
    assert len(paged) == 16
    assert paged == _drive(leg, _requests(Request, cfg, 16, seed=3))
    rep = eng.cache_report()
    assert rep["family"] == "kv+mem"
    assert rep["memory_pool_bytes"] == paged_cache.memory_bytes(eng.pools) \
        == 9 * cfg.enc_len * cfg.d_model * 4
    _assert_no_leaks(eng)
    assert eng.free_slots == eng.usable_slots


def test_constant_state_zeroed_on_reuse():
    """tests/test_engine_parity.py:194, "encdec": two waves through one
    engine (the second reuses freed slots, whose memory rows the encoder
    rewrites) give the second wave a fresh engine's tokens."""
    _, _, cfg, params = models()
    eng = Engine(cfg, params, batch_slots=4, max_len=64, device="cpu")
    _drive(eng, _requests(Request, cfg, 6, seed=1))
    got = _drive(eng, _requests(Request, cfg, 6, seed=2))
    fresh = Engine(cfg, params, batch_slots=4, max_len=64, device="cpu")
    assert got == _drive(fresh, _requests(Request, cfg, 6, seed=2))


def test_preemption_restores_the_memory_row():
    """A tight page pool evicts enc-dec sequences mid-decode; the
    snapshot carries the kv pages and the memory row, which the restore
    writes into the slot it is re-admitted to: tokens equal the roomy
    pool's and the reference's tight run's, with its preemptions."""
    jcfg, jparams, cfg, params = models()
    rng = np.random.default_rng(0)
    blue = [(rng.integers(0, cfg.vocab, 3).astype(np.int32),
             F.synthetic_audio_features(rng, cfg)) for _ in range(4)]

    def drive(pkg, c, p, pages):
        sched = pkg.SchedConfig(max_batch=4, prefill_batch=2,
                                prefill_chunk=4, page_size=4,
                                num_pages=pages, table_width=4)
        if pkg is jserving:
            eng = _ref_engine(c, p, batch_slots=4, max_len=16, sched=sched)
        else:
            eng = pkg.Engine(c, p, batch_slots=4, max_len=16, sched=sched,
                             device="cpu")
        out = _drive(eng, [pkg.Request(uid=i, prompt=q.copy(), max_new=10,
                                       enc_emb=e)
                           for i, (q, e) in enumerate(blue)])
        return out, eng.stats["preemptions"]

    import repro_torch.serving as tserving
    tight, n_pre = drive(tserving, cfg, params, 9)
    roomy, _ = drive(tserving, cfg, params, 33)
    ref, ref_pre = drive(jserving, jcfg, jparams, 9)
    assert n_pre > 0, "the pool was not tight enough to preempt"
    assert tight == roomy == ref and n_pre == ref_pre


# ---------------------------------------------------------------------------
# the prefix cache's encoder-content namespaces
# ---------------------------------------------------------------------------

SCENARIOS = ["hit", "partial", "miss", "evict", "cow"]
PREFIX_COUNTERS = ("prefix_lookups_total", "prefix_hits_total",
                   "prefix_hit_tokens_total", "prefix_cow_forks_total",
                   "prefix_evictions_total", "prefix_inserted_pages_total",
                   "engine_prefill_tokens_total")


def _waves(cls, cfg, scenario):
    """tests/test_prefix_serving.py's ``_scenario_waves`` for enc-dec:
    one feature array for the donor and the wave."""
    rng = np.random.default_rng(0)
    shared = rng.integers(1, cfg.vocab, 36).astype(np.int32)
    enc = F.synthetic_audio_features(rng, cfg)
    tails = [rng.integers(1, cfg.vocab, 3 + i).astype(np.int32)
             for i in range(5)]
    donors = [cls(uid=100, prompt=shared.copy(), max_new=2, enc_emb=enc)]
    if scenario in ("hit", "evict", "cow"):
        wave = [cls(uid=i, prompt=np.concatenate([shared, t]), max_new=6,
                    enc_emb=enc) for i, t in enumerate(tails)]
    elif scenario == "partial":
        wave = [cls(uid=i, prompt=np.concatenate([shared[:20], t, t]),
                    max_new=6, enc_emb=enc) for i, t in enumerate(tails)]
    else:
        wave = [cls(uid=i, prompt=rng.integers(1, cfg.vocab, 20 + i)
                    .astype(np.int32), max_new=6, enc_emb=enc)
                for i in range(5)]
    return donors, wave


def _prefix_run(pkg, cfg, params, scenario, prefix):
    kw = dict(batch_slots=4, max_len=64)
    if scenario == "evict":
        kw["sched"] = pkg.SchedConfig(max_batch=2, prefill_batch=2,
                                      prefill_chunk=16, page_size=8,
                                      num_pages=12, table_width=7)
    if prefix:
        kw["prefix"] = pkg.PrefixConfig(chunk=pkg.ChunkConfig(
            chunk_tokens=16))
    eng = _ref_engine(cfg, params, **kw) if pkg is jserving else \
        pkg.Engine(cfg, params, device="cpu", **kw)
    donors, wave = _waves(pkg.Request, cfg, scenario)
    _drive(eng, donors)
    toks = _drive(eng, wave)
    v = eng.metrics.value_sum
    return toks, {c: int(v(c)) for c in PREFIX_COUNTERS}, eng


@pytest.mark.parametrize("scenario", SCENARIOS)
def test_prefix_matrix_matches_reference(scenario):
    """tests/test_prefix_serving.py:295, the encdec row: warm tokens equal
    the cold engine's and the reference's warm engine's, the prefix
    counters equal the reference's, hits as the reference's test says
    (a divergence inside the prompt still reuses the first full page:
    enc-dec carries no slot state to resume), and no page or slot
    leaks."""
    import repro_torch.serving as tserving
    jcfg, jparams, cfg, params = models()
    cold, _, ceng = _prefix_run(tserving, cfg, params, scenario, False)
    _assert_no_leaks(ceng)
    got, counts, eng = _prefix_run(tserving, cfg, params, scenario, True)
    want, jcounts, _ = _prefix_run(jserving, jcfg, jparams, scenario, True)
    assert got == cold == want
    assert counts == jcounts
    hit = counts["prefix_hit_tokens_total"]
    assert (hit > 0) == (scenario in ("hit", "partial", "cow", "evict"))
    if scenario == "evict":
        assert counts["prefix_evictions_total"] > 0
    if scenario == "cow":
        assert counts["prefix_cow_forks_total"] > 0
    _assert_no_leaks(eng)


def test_features_partition_the_trie():
    """Equal features share the trie; a request with the same tokens and
    other features misses (its decoder KV differs), and its tokens are a
    cold engine's."""
    _, _, cfg, params = models()
    eng = Engine(cfg, params, batch_slots=4, max_len=64, device="cpu",
                 prefix=PrefixConfig())
    rng = np.random.default_rng(5)
    prompt = rng.integers(1, cfg.vocab, 40).astype(np.int32)
    a, b = (F.synthetic_audio_features(rng, cfg) for _ in range(2))
    _drive(eng, [Request(uid=0, prompt=prompt.copy(), max_new=2,
                         enc_emb=a)])
    hits = eng.metrics.value_sum
    same = _drive(eng, [Request(uid=1, prompt=prompt.copy(), max_new=4,
                                enc_emb=a.copy())])
    after_same = hits("prefix_hit_tokens_total")
    other = _drive(eng, [Request(uid=2, prompt=prompt.copy(), max_new=4,
                                 enc_emb=b)])
    assert after_same > 0
    assert hits("prefix_hit_tokens_total") == after_same
    cold = Engine(cfg, params, batch_slots=4, max_len=64, device="cpu")
    assert other == _drive(cold, [Request(uid=2, prompt=prompt.copy(),
                                          max_new=4, enc_emb=b)])
    assert same[1] == _drive(cold, [Request(uid=1, prompt=prompt.copy(),
                                            max_new=4, enc_emb=a)])[1]


def test_enc_dec_request_needs_features():
    _, _, cfg, params = models()
    eng = Engine(cfg, params, batch_slots=2, max_len=64, device="cpu")
    with pytest.raises(ValueError, match="enc_emb"):
        eng.submit(Request(uid=0, prompt=np.ones(3, np.int32)))


def test_train_steps_match_reference(tmp_path, capsys):
    """Two steps of ``make_train_step`` on the synthetic stream's enc-dec
    batches: losses within 1e-5 of the reference's from the same params;
    then the training launcher trains the reduced config on the CPU."""
    from repro.optim import adamw as jadamw
    from repro_torch.data import synth
    from repro_torch.launch import train as train_cli
    from repro_torch.optim import adamw
    jcfg, jparams, cfg, params = models()
    jstep = jax.jit(jsteps.make_train_step(jcfg, jsteps.TrainHyper(
        lr=1e-3, warmup=1, total_steps=4)))
    fn = steps.make_train_step(cfg, steps.TrainHyper(lr=1e-3, warmup=1,
                                                     total_steps=4))
    p = T.requires_grad(tree_lib.map(lambda t: t.clone(), params))
    state, jp, jstate = adamw.init(p), jparams, jadamw.init(jparams)
    for i in range(2):
        hb = synth.full_batch(cfg, 2, 24, i)
        p, state, m = fn(p, state, i, {k: torch.from_numpy(v)
                                       for k, v in hb.items()})
        jp, jstate, jm = jstep(jp, jstate, i, {k: jnp.asarray(v)
                                               for k, v in hb.items()})
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                                   rtol=1e-5)
    assert train_cli.main(["--arch", ARCH, "--reduced", "--device", "cpu",
                           "--steps", "2", "--batch", "2", "--seq", "16",
                           "--ckpt-dir", str(tmp_path)]) == 0
    assert '"step": 2' in capsys.readouterr().out


CLI = [([], "'family': 'kv+mem'"), (["--attn", "srf"], "'family': 'srf+mem'"),
       (["--quantize-kv"], "'family': 'kv+mem'"),
       (["--legacy"], "engine=legacy"),
       (["--prefix-cache", "--shared-prefix", "16", "--prompt-len", "24"],
        "prefix: hits="),
       (["--replicas", "2", "--ft", "--chaos", "raise@2:1"], "engine=router")]


@pytest.mark.parametrize("flags,expect", CLI,
                         ids=["kv", "srf", "int8", "legacy", "prefix",
                              "router"])
def test_cli_serves_reduced_on_cpu(capsys, flags, expect):
    """The serve CLI gives each enc-dec request its own features."""
    args = ["--arch", ARCH, "--reduced", "--device", "cpu", "--requests",
            "3", "--prompt-len", "20", "--max-new", "4", "--slots", "2"]
    assert serve.main(args + flags) == 0
    out = capsys.readouterr().out
    assert "requests=3 tokens=12" in out and expect in out
    a = serve.parser().parse_args(args)
    reqs = serve.requests(a, serve.config(a))
    assert all(r.enc_emb.shape == (16, F.AUDIO_FEAT_DIM) for r in reqs)
    assert len({engine_lib._enc_namespace(r.enc_emb) for r in reqs}) == 3
