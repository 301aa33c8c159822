"""MLA latent attention and the deepseek-v2-lite-16b config (MLA with MoE)
in the port against the reference on the CPU: reduced configs (f32,
4 query / 2 kv heads, kv_lora 32, qk 16 + 8 rope, v 16), the reference's
params carried over with ``convert.params_from_jax``.

* MLA attention (``attention._mla_attention``) against the reference's
  in train, prefill and decode modes (outputs, and the latent caches c /
  kpe or the SRF state) and in the paged mode: one chunked-prefill step
  and one decode step against the reference's latent pages (every page
  but the null page 0, where the port writes the padded rows the
  reference drops) or SRF slots (slot 0 excepted); tolerance 1e-5 of the
  largest. SRF under MLA holds one P-model per query head.
* The model (2 layers: one dense, one moe, cf 8.0): forward and loss,
  prefill and decode against the forward and against the reference, the
  paged step with MLA latent pages and with MLA + SRF, the pool plans
  and bytes per token (``--quantize-kv`` leaves the latents in the
  model's dtype).
* The engines: greedy tokens of the port's paged engine equal its
  legacy engine's and the reference paged engine's, sampled tokens the
  reference's; seeded SRF under MLA with per-request embed seeds equal
  the reference's; 16 mixed-length requests through 8 slots; the CLI.
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
from repro.models import attention as jA
from repro.models import transformer as jT
from repro.serving import paged_cache as jcache
from repro_torch import convert
from repro_torch.configs import registry
from repro_torch.launch import serve
from repro_torch.models import attention as A
from repro_torch.models import transformer as T
from repro_torch.serving import Engine, PagedConfig, Request, paged_cache

ARCH = "deepseek-v2-lite-16b"
ATTN_RTOL = 1e-5       # of the largest |output| of one attention layer
LOGIT_RTOL = 1e-4      # of the largest |logit|, through the layers
IMPLS = ["full", "srf"]

_models = {}
# the reference's attention, jitted (cfg and mode static)
_jattention = jax.jit(jA.attention, static_argnums=(1, 4))


def _seeded(cfg):
    return dataclasses.replace(cfg, srf=dataclasses.replace(cfg.srf,
                                                            seeded=True))


def models(attn="full", seeded=False):
    """Both packages' reduced configs (2 layers, cf 8.0) and params."""
    key = (attn, seeded)
    if key not in _models:
        over = dict(n_layers=2, moe_capacity_factor=8.0, attn_impl=attn)
        jcfg = jregistry.reduced(ARCH, **over)
        cfg = registry.reduced(ARCH, **over)
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


def _close(got, want, rtol):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=rtol * np.abs(want).max())


def _attn_params(attn):
    """Layer 0's attention params in both packages."""
    jcfg, jparams, cfg, params = models(attn)
    return (jcfg, jax.tree.map(lambda a: a[0], jparams["segments"][0]["attn"]),
            cfg, jax.tree.map(lambda t: t[0], params["segments"][0]["attn"]))


# ---------------------------------------------------------------------------
# MLA attention
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("attn", IMPLS)
def test_mla_attention_modes_match_reference(attn):
    """Train mode over 12 tokens; then prefill of 10 tokens into a cache
    of 16 and three decode steps: outputs, and the latent caches (c, kpe)
    or the SRF state (s, z) after each, with the position."""
    jcfg, jp, cfg, p = _attn_params(attn)
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 13, cfg.d_model)).astype(np.float32)
    pos = np.tile(np.arange(13), (2, 1))
    want, _ = _jattention(jp, jcfg, jnp.asarray(x[:, :12]),
                           jnp.asarray(pos[:, :12]), "train")
    _close(A.attention(p, cfg, torch.from_numpy(x[:, :12]),
                       torch.from_numpy(pos[:, :12]), "train"), want,
           ATTN_RTOL)
    jc = jA.init_cache(jcfg, 2, 16, jnp.float32)
    c = A.init_cache(cfg, 2, 16, torch.float32)
    assert {k: tuple(v.shape) for k, v in c.items() if k != "idx"} == \
        {k: tuple(v.shape) for k, v in jc.items() if k != "idx"}
    for lo, hi, mode in ((0, 10, "prefill"), (10, 11, "decode"),
                         (11, 12, "decode"), (12, 13, "decode")):
        want, jc = _jattention(jp, jcfg, jnp.asarray(x[:, lo:hi]),
                                jnp.asarray(pos[:, lo:hi]), mode, jc)
        got = A.attention(p, cfg, torch.from_numpy(x[:, lo:hi]),
                          torch.from_numpy(pos[:, lo:hi]), mode, c)
        _close(got, want, ATTN_RTOL)
        for k in c:
            if k != "idx":
                _close(c[k], jc[k], ATTN_RTOL)
        assert c["idx"] == int(jc["idx"]) == hi


@pytest.mark.parametrize("attn", IMPLS)
def test_mla_paged_matches_reference(attn):
    """A chunked-prefill step (rows of 8, 5 and 0 valid tokens; the last
    row padding on the null page / slot) and a decode step through one
    MLA layer: the live rows' outputs, then the latent pages (page 0
    excepted) or the SRF slots (slot 0 excepted)."""
    jcfg, jp, cfg, p = _attn_params(attn)
    fam = paged_cache.attn_family_for(cfg)
    jfam = jcache.attn_family_for(jcfg)
    assert fam.name == jfam.name == {"full": "mla", "srf": "srf"}[attn]
    n, pg, b, c, w = 9, 4, 3, 8, 4
    pool = fam.layer_pool(cfg, n, pg, device="cpu")
    jpool = jfam.layer_pool(jcfg, n, pg)
    assert {k: tuple(v.shape) for k, v in pool.items()} == \
        {k: tuple(v.shape) for k, v in jpool.items()}
    tables = np.array([[1, 2, 3, 0], [4, 5, 0, 0], [0, 0, 0, 0]], np.int32)
    slots = np.array([1, 2, 0], np.int32)
    rng = np.random.default_rng(1)
    lengths = np.array([8, 5, 0])
    steps = [(np.tile(np.arange(c), (b, 1)),
              np.arange(c)[None] < lengths[:, None], c),
             ((lengths)[:, None], (lengths > 0)[:, None], 1)]
    for pos, qv, cc in steps:
        x = rng.standard_normal((b, cc, cfg.d_model)).astype(np.float32)
        jctx = {"pool": jpool, "tables": jnp.asarray(tables),
                "slots": jnp.asarray(slots), "q_valid": jnp.asarray(qv)}
        want, jpool = _jattention(jp, jcfg, jnp.asarray(x),
                                   jnp.asarray(pos.astype(np.int32)),
                                   "paged", jctx)
        ctx = {"pool": pool, "tables": torch.from_numpy(tables).long(),
               "slots": torch.from_numpy(slots).long(),
               "q_valid": torch.from_numpy(qv)}
        got = A.attention(p, cfg, torch.from_numpy(x),
                          torch.from_numpy(pos).long(), "paged", ctx)
        live = qv.any(axis=1)
        _close(_np(got)[live], _np(want)[live], ATTN_RTOL)
    for k in pool:
        _close(_np(pool[k])[1:], _np(jpool[k])[1:], ATTN_RTOL)


def test_srf_pmodels_one_per_query_head():
    """Under MLA the SRF P-models are per query head: 4 in the reduced
    config, where GQA would hold one per kv head (2); the port's own init
    has the reference's shapes."""
    jcfg, jparams, cfg, params = models("srf")
    assert cfg.n_heads == 4 != cfg.n_kv_heads == 2
    srf = params["segments"][0]["attn"]["srf"]
    assert all(t.shape[:2] == (1, cfg.n_heads)
               for blk in srf for t in blk.values())
    mine = T.init(cfg, seed=0, device="cpu")
    assert jax.tree.map(lambda t: tuple(t.shape), mine) == \
        jax.tree.map(lambda t: tuple(t.shape), params)
    assert A.srf_cfg(cfg).head_dim == cfg.mla_qk_dim == 24
    assert not A.srf_cfg(cfg).use_hd        # 24 is not a power of 2


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("attn", IMPLS)
def test_forward_and_loss_match_reference(attn):
    """Logits within 1e-4 of the largest; loss and aux within 1e-5."""
    jcfg, jparams, cfg, params = models(attn)
    toks = np.random.default_rng(0).integers(0, cfg.vocab, (2, 32))
    batch = {"tokens": toks, "labels": np.roll(toks, -1, axis=1)}
    want, jloss, jm = jax.jit(lambda p, b: (
        jT.forward(p, jcfg, {"tokens": b["tokens"]})[0],
        *jT.loss_fn(p, jcfg, b)))(jparams, jax.tree.map(jnp.asarray, batch))
    got, _ = T.forward(params, cfg, {"tokens": torch.from_numpy(toks)})
    assert torch.isfinite(got).all()
    _close(got, want, LOGIT_RTOL)
    loss, m = T.loss_fn(params, cfg, {k: torch.from_numpy(v)
                                      for k, v in batch.items()})
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    np.testing.assert_allclose(float(m["aux"]), float(jm["aux"]), rtol=1e-5)


@pytest.mark.parametrize("attn", IMPLS)
def test_prefill_decode_consistency(attn):
    """tests/test_models_smoke.py:65 for deepseek on the port (cf 8.0):
    prefill and decode logits equal the forward's within 2e-4 of its
    largest."""
    cfg = registry.reduced(ARCH, moe_capacity_factor=8.0, attn_impl=attn)
    params = T.init(cfg, seed=0, device="cpu")
    b, p, n = 2, 16, 3
    toks = torch.from_numpy(np.random.default_rng(3).integers(
        0, cfg.vocab, (b, p + n)))
    full, _ = T.forward(params, cfg, {"tokens": toks})
    cache = T.init_serve_cache(cfg, b, p + n, device="cpu")
    lp, cache = T.prefill(params, cfg, {"tokens": toks[:, :p]}, cache)
    scale = float(full.abs().max())
    errs = [float((lp[:, 0] - full[:, p - 1]).abs().max())]
    for i in range(n):
        ld, cache = T.decode_step(params, cfg, cache,
                                  toks[:, p + i:p + i + 1])
        errs.append(float((ld[:, 0] - full[:, p + i]).abs().max()))
    assert max(errs) / scale < 2e-4, errs


@pytest.mark.parametrize("attn", IMPLS)
def test_prefill_decode_match_reference(attn):
    """The legacy engine's cache path (a prompt of 10, three decode
    steps) against the reference's: logits and every cache leaf."""
    jcfg, jparams, cfg, params = models(attn)
    toks = np.random.default_rng(4).integers(0, cfg.vocab, (2, 13))
    jc = jT.init_serve_cache(jcfg, 2, 16)
    c = T.init_serve_cache(cfg, 2, 16, device="cpu")
    jdecode = jax.jit(jT.decode_step, static_argnums=1)
    want, jc = jax.jit(jT.prefill, static_argnums=1)(
        jparams, jcfg, {"tokens": jnp.asarray(toks[:, :10])}, jc)
    got, c = T.prefill(params, cfg, {"tokens": torch.from_numpy(
        toks[:, :10])}, c)
    _close(got, want, LOGIT_RTOL)
    for t in range(10, 13):
        want, jc = jdecode(jparams, jcfg, jc, jnp.asarray(toks[:, t:t + 1]))
        got, c = T.decode_step(params, cfg, c,
                               torch.from_numpy(toks[:, t:t + 1]))
        _close(got, want, LOGIT_RTOL)
    for seg, jseg in zip(c["segments"], jc["segments"]):
        assert set(seg) == set(jseg)
        for k in seg:
            if k != "idx":
                _close(seg[k], jseg[k], LOGIT_RTOL)
        assert seg["idx"] == int(jseg["idx"][0]) == 13 == c["pos"]


_ref_steps = {}


def _ref_engine(jcfg, jparams, **kw):
    """A reference paged engine; engines of one config share the first
    one's jitted step (the reference jits anew per engine)."""
    eng = jserving.Engine(jcfg, jparams, **kw)
    eng._step = _ref_steps.setdefault((eng.cfg, eng.paged), eng._step)
    return eng


@pytest.mark.parametrize("attn", IMPLS)
def test_paged_step_matches_reference(attn):
    """At a 4-slot engine's pool geometry and batch shapes, against the
    step that engine jits: a chunk (rows of c, 5 and c - 3 valid tokens
    and a padding row) and two decode steps; the live rows' logits within
    1e-4 of the largest, then every latent page (page 0 excepted) or SRF
    slot (slot 0 excepted)."""
    jcfg, jparams, cfg, params = models(attn)
    eng = _ref_engine(jcfg, jparams, batch_slots=4, max_len=64)
    sc, n_slots = eng.sched_cfg, eng.sched.num_slots
    b, c, w = sc.max_batch, sc.prefill_chunk, sc.table_width
    jpools = jcache.init_pools(jcfg, sc.num_pages, sc.page_size,
                               num_slots=n_slots)
    pools = paged_cache.init_pools(cfg, sc.num_pages, sc.page_size,
                                   num_slots=n_slots, device="cpu")
    slots = np.array([1, 3, 4, 0], np.int32)
    tables = np.zeros((b, w), np.int32)
    if eng.plan.has_paged:
        tables[:-1] = np.arange(1, 1 + (b - 1) * w).reshape(b - 1, w)
    rng = np.random.default_rng(0)
    lengths = np.array([c, 5, c - 3, 0])
    steps = [(rng.integers(0, cfg.vocab, (b, c)), np.tile(np.arange(c),
                                                          (b, 1)),
              np.arange(c)[None, :] < lengths[:, None])]
    for t in range(2):
        steps.append((rng.integers(0, cfg.vocab, (b, 1)),
                      (lengths + t)[:, None], (lengths > 0)[:, None]))
    for tok, pos, qv in steps:
        tok, pos = tok.astype(np.int32), pos.astype(np.int32)
        want, jpools = eng._step(jparams, jpools, *map(jnp.asarray, (
            tok, pos, qv, tables, slots)))
        got, pools = T.paged_step(params, cfg, pools, torch.from_numpy(tok),
                                  torch.from_numpy(pos).long(),
                                  torch.from_numpy(qv),
                                  torch.from_numpy(tables).long(),
                                  torch.from_numpy(slots).long())
        live = qv.any(axis=1)
        _close(_np(got)[live], _np(want)[live], LOGIT_RTOL)
    for part in ("paged", "slot"):
        for seg, jseg in zip(pools[part], jpools[part]):
            assert (seg is None) == (jseg is None)
            for comp, leaves in (seg or {}).items():
                for k, a in leaves.items():
                    _close(_np(a)[:, 1:], _np(jseg[comp][k])[:, 1:],
                           LOGIT_RTOL)


def test_plan_and_bytes_per_token_match_reference():
    """deepseek's plans ("mla", "srf") and per-layer bytes a token equal
    the reference's, reduced and at full width, with and without
    ``quantize_kv`` (only the kv family quantizes: the latents keep the
    model's dtype). Full width: 31,104 B of bf16 latents a token (27
    layers x (512 + 64) x 2), 12.6x fewer than moonshot's KV pages."""
    for full in (False, True):
        for attn, name in (("full", "mla"), ("srf", "srf")):
            get = registry.get if full else registry.reduced
            jget = jregistry.get if full else jregistry.reduced
            cfg, jcfg = get(ARCH, attn_impl=attn), jget(ARCH, attn_impl=attn)
            pp, jp = paged_cache.plan_for(cfg), jcache.plan_for(jcfg)
            assert pp.name == jp.name == name
            assert pp.segments == jp.segments == (
                ("dense", 1, (("attn", name),)),
                ("moe", cfg.n_layers - 1, (("attn", name),)))
            for quant in (False, True):
                assert pp.bytes_per_token(cfg, 256, PagedConfig(quant)) == \
                    jp.bytes_per_token(jcfg, 256, jcache.PagedConfig(quant))
    full = registry.get(ARCH)
    per_tok = paged_cache.plan_for(full).bytes_per_token(full, 256) \
        * full.n_layers
    assert per_tok == 31104
    kv = registry.get("moonshot-v1-16b-a3b")
    assert round(paged_cache.plan_for(kv).bytes_per_token(kv, 256)
                 * kv.n_layers / per_tok, 1) == 12.6
    cfg = registry.reduced(ARCH, n_layers=2)
    pools = paged_cache.init_pools(cfg, 5, 4, device="cpu",
                                   paged=PagedConfig(quantize_kv=True))
    assert {k: (tuple(t.shape), t.dtype) for k, t in
            pools["paged"][1]["attn"].items()} == {
        "c": ((1, 5, 4, 32), torch.float32),
        "kpe": ((1, 5, 4, 8), torch.float32)}
    assert pools["slot"] == [None, None]


# ---------------------------------------------------------------------------
# the engines
# ---------------------------------------------------------------------------

def _requests(cls, cfg, n, seed=0, temperature=0.0, embed=False):
    """test_engine_parity._requests's recipe; ``embed``: a non-zero
    embed seed on all but every third request."""
    rng = np.random.default_rng(seed)
    return [cls(uid=i, prompt=rng.integers(0, cfg.vocab, int(
        rng.integers(2, 20))).astype(np.int32),
        max_new=int(rng.integers(3, 7)), temperature=temperature,
        embed_seed=(1000 * i + 7) if embed and i % 3 else 0)
        for i in range(n)]


def _drive(eng, reqs):
    for r in reqs:
        eng.submit(r)
    done = eng.run()
    for r in done:
        assert r.t_submit <= r.t_first <= r.t_done
    return {r.uid: list(r.out_tokens) for r in done}


PARITY = [("full", 0.0), ("full", 0.8), ("srf", 0.0)]


@pytest.mark.parametrize("attn,temperature", PARITY,
                         ids=[f"{a}-{'sampled' if t else 'greedy'}"
                              for a, t in PARITY])
def test_paged_equals_legacy_equals_reference(attn, temperature):
    """8 mixed-length requests, 4 slots (tests/test_engine_parity.py:95,
    :125, the fast set's mla cell): the port's paged tokens equal the
    reference paged engine's and the port's legacy engine's, greedy and
    sampled."""
    jcfg, jparams, cfg, params = models(attn)
    eng = Engine(cfg, params, batch_slots=4, max_len=64, seed=5,
                 device="cpu")
    paged = _drive(eng, _requests(Request, cfg, 8, 0, temperature))
    assert len(paged) == 8 and eng.nonfinite_rows == 0
    ref = _ref_engine(jcfg, jparams, batch_slots=4, max_len=64, seed=5)
    assert paged == _drive(ref, _requests(jserving.Request, jcfg, 8, 0,
                                          temperature))
    assert eng.sched.alloc.used_pages == 0
    if eng.plan.needs_slot:
        assert eng.free_slots == eng.usable_slots
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        from repro_torch.serving import legacy
    leg = legacy.Engine(cfg, params, batch_slots=4, max_len=64, seed=5,
                        device="cpu")
    assert _drive(leg, _requests(Request, cfg, 8, 0, temperature)) == paged


def test_seeded_srf_with_embed_seeds_matches_reference():
    """Seeded SRF under MLA (one seed per layer and query head; qk 24,
    no HD) with per-request embed seeds: the port's paged tokens equal
    the reference engine's, and the embed seeds change some."""
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


def test_mla_engine_mixed_lengths():
    """tests/test_paged_serving.py:122, the mla case: 16 requests of 2-23
    prompt tokens through 8 slots all finish with max_new tokens, every
    page comes back, and the cache report names the family."""
    _, _, cfg, params = models()
    eng = Engine(cfg, params, batch_slots=8, max_len=64, device="cpu")
    rng = np.random.default_rng(0)
    for i in range(16):
        eng.submit(Request(uid=i, prompt=rng.integers(
            0, cfg.vocab, int(rng.integers(2, 24))).astype(np.int32),
            max_new=int(rng.integers(3, 8))))
    done = eng.run()
    assert len(done) == 16
    assert all(len(r.out_tokens) == r.max_new for r in done)
    assert eng.stats["requests"] == 16
    assert eng.sched.alloc.used_pages == 0
    rep = eng.cache_report()
    assert rep["family"] == "mla"
    assert rep["pool_bytes"] == paged_cache.pool_bytes(eng.pools)


CLI = [([], "'family': 'mla'"), (["--attn", "srf"], "'family': 'srf'"),
       (["--quantize-kv"], "'family': 'mla'"),
       (["--legacy"], "engine=legacy")]


@pytest.mark.parametrize("flags,expect", CLI,
                         ids=["".join(f) or "mla" for f, _ in CLI])
def test_cli_serves_reduced_on_cpu(capsys, flags, expect):
    args = ["--arch", ARCH, "--reduced", "--device", "cpu", "--requests",
            "3", "--prompt-len", "20", "--max-new", "4", "--slots", "2"]
    assert serve.main(args + flags) == 0
    out = capsys.readouterr().out
    assert "requests=3 tokens=12" in out and expect in out
