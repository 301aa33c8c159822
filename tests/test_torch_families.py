"""The SSD (mamba2-2.7b) and hybrid (hymba-1.5b) families in the port
against the reference on the CPU: reduced configs (2 layers, f32), the
reference's params carried over with ``convert.params_from_jax``.

* The model: the training forward, prefill and decode, and the paged
  step (a chunk with tail padding, then decode steps; hymba with full-KV
  pages, int8 pages and SRF state) give the reference's logits within
  1e-4 of the largest (f32: the frameworks sum in another order, and the
  error grows through the layers) and its slot states within 1e-5
  relative; the reference's smoke checks (``tests/test_models_smoke.py``:
  forward shapes and no NaN, prefill and decode against the forward).
* The engines (``tests/test_engine_parity.py``): greedy and sampled
  tokens of the port's paged engine equal its legacy engine's and the
  reference paged engine's (int8 pages: greedy, against the legacy int8
  cache); sampling is a function of the engine seed; 16 concurrent
  hymba requests; hybrid preemption restores the
  kv pages and the ssd slot state; a reused slot starts from zero; the
  SSD engine serves mixed lengths (``tests/test_paged_serving.py``).
* The prefix cache (``tests/test_prefix_serving.py``): the hybrid
  scenarios give the cold engine's and the reference's tokens with the
  reference's prefix counters (a divergence inside the prompt misses: no
  donor state there), and the traces' milestones; a pure SSD plan keeps
  the cache off.
* The serve CLI serves both families reduced on the CPU (paged, legacy,
  int8 pages, SRF, the prefix cache, the FT router with a chaos fault).
"""
import warnings
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import serving as jserving
from repro.configs import registry as jregistry
from repro.models import transformer as jT
from repro.serving import paged_cache as jcache
from repro_torch import convert
from repro_torch import tree as tree_lib
from repro_torch.configs import registry
from repro_torch.launch import serve
from repro_torch.models import transformer as T
from repro_torch.serving import (ChunkConfig, Engine, PagedConfig,
                                 PrefixConfig, Request, paged_cache)

# one intra-op thread: the suite's pytest-xdist workers share the
# cores, and oversubscribed OpenMP pools spin against each other
torch.set_num_threads(1)

LOGIT_RTOL = 1e-4
STATE_RTOL = 1e-5
# cell -> (arch, config overrides, int8 pages)
CELLS = {"ssd": ("mamba2-2.7b", {}, False),
         "hybrid": ("hymba-1.5b", {}, False),
         "hybrid int8": ("hymba-1.5b", {}, True),
         "hybrid srf": ("hymba-1.5b", {"attn_impl": "srf"}, False)}
ARCHS = ["mamba2-2.7b", "hymba-1.5b"]

_models = {}


def _legacy():
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        from repro.serving import legacy as jlegacy
        from repro_torch.serving import legacy
    return legacy, jlegacy


def models(arch, **over):
    """Both packages' reduced configs and params (cached)."""
    key = (arch, tuple(sorted(over.items())))
    if key not in _models:
        jcfg = jregistry.reduced(arch, n_layers=2, **over)
        cfg = registry.reduced(arch, n_layers=2, **over)
        jparams = jax.jit(jT.init, static_argnums=1)(jax.random.PRNGKey(0),
                                                     jcfg)
        params = convert.params_from_jax(jax.tree.map(np.asarray, jparams),
                                         cfg, device="cpu")
        _models[key] = (jcfg, jparams, cfg, params)
    return _models[key]


def _cell(cell):
    arch, over, quant = CELLS[cell]
    return (*models(arch, **over), quant)


_ref_steps = {}


def _ref_engine(jcfg, jparams, quant=False, **kw):
    """A reference paged engine. The reference wraps its step in a new
    ``jax.jit`` per engine, so each engine would compile anew; engines
    of one (config, page layout) here share the first one's jitted step
    (the same function: ``make_paged_step(cfg, paged=...)``), which
    keeps its compiled shapes."""
    eng = jserving.Engine(jcfg, jparams, paged=jserving.PagedConfig(quant),
                          **kw)
    eng._step = _ref_steps.setdefault((eng.cfg, eng.paged), eng._step)
    return eng


def _close(got, want, rtol=LOGIT_RTOL):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=rtol * np.abs(want).max())


def _np(a):
    return a.detach().float().numpy() if isinstance(a, torch.Tensor) \
        else np.asarray(a.astype(jnp.float32))


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_convert_keeps_layout_and_port_init_matches(arch):
    """The reference's tree carried over leaf for leaf (the ssm leaves,
    hybrid's fusion norms), and the port's own init has its layout."""
    jcfg, jparams, cfg, params = models(arch)
    jl = jax.tree_util.tree_leaves_with_path(jparams)
    tl = jax.tree_util.tree_leaves_with_path(
        jax.tree.map(lambda t: t.numpy(), params))
    assert [p for p, _ in jl] == [p for p, _ in tl]
    for (_, a), (_, b) in zip(jl, tl):
        np.testing.assert_array_equal(np.asarray(a), b)
    mine = T.init(cfg, seed=0, device="cpu")
    assert jax.tree.map(lambda t: tuple(t.shape), mine) == \
        jax.tree.map(lambda t: tuple(t.shape), params)
    kinds = {"mamba2-2.7b": "ssm", "hymba-1.5b": "hybrid"}
    assert T.segments(cfg) == [(kinds[arch], 2)]


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_and_loss_match_reference(arch):
    """tests/test_models_smoke.py:68 on the port (shapes, no NaN), and
    the logits and loss against the reference's forward."""
    jcfg, jparams, cfg, params = models(arch)
    toks = np.random.default_rng(0).integers(0, cfg.vocab, (2, 32))
    batch = {"tokens": toks, "labels": np.roll(toks, -1, axis=1)}
    want, jloss = jax.jit(lambda p, b: (   # one compile for both
        jT.forward(p, jcfg, {"tokens": b["tokens"]})[0],
        jT.loss_fn(p, jcfg, b)[0]))(jparams, jax.tree.map(jnp.asarray,
                                                          batch))
    got, aux = T.forward(params, cfg, {"tokens": torch.from_numpy(toks)})
    assert got.shape == (2, 32, cfg.padded_vocab)
    assert torch.isfinite(got).all() and float(aux) == 0.0
    _close(_np(got), want)
    loss, _ = T.loss_fn(params, cfg, {k: torch.from_numpy(v)
                                      for k, v in batch.items()})
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_decode_consistency(arch):
    """tests/test_models_smoke.py:93 on the port: prefill and decode
    logits equal the training forward's within 2e-4 of its largest."""
    cfg = registry.reduced(arch)
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
    assert max(errs) / scale < 2e-4, (arch, errs)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_decode_match_reference(arch):
    """The legacy engine's cache path against the reference's: prefill
    logits, three decode steps, and the caches (a hybrid segment's
    {"attn", "ssm"} halves, each with its "idx")."""
    jcfg, jparams, cfg, params = models(arch)
    toks = np.random.default_rng(4).integers(0, cfg.vocab, (2, 13))
    jc = jT.init_serve_cache(jcfg, 2, 16)
    c = T.init_serve_cache(cfg, 2, 16, device="cpu")
    shapes = {p: tuple(a.shape) for p, a in tree_lib.leaves_with_path(
        c["segments"]) if not p.endswith("idx")}
    assert shapes == {jax.tree_util.keystr(p, simple=True, separator="/"):
                      tuple(a.shape) for p, a in
                      jax.tree_util.tree_leaves_with_path(jc["segments"])
                      if not jax.tree_util.keystr(p).endswith("'idx']")}
    jdecode = jax.jit(jT.decode_step, static_argnums=1)
    want, jc = jax.jit(jT.prefill, static_argnums=1)(
        jparams, jcfg, {"tokens": jnp.asarray(toks[:, :10])}, jc)
    got, c = T.prefill(params, cfg, {"tokens": torch.from_numpy(
        toks[:, :10])}, c)
    _close(_np(got), want)
    for t in range(10, 13):
        want, jc = jdecode(jparams, jcfg, jc, jnp.asarray(toks[:, t:t + 1]))
        got, c = T.decode_step(params, cfg, c,
                               torch.from_numpy(toks[:, t:t + 1]))
        _close(_np(got), want)
    seg, jseg = c["segments"][0], jc["segments"][0]
    ssm, jssm = (seg, jseg) if arch == "mamba2-2.7b" else \
        (seg["ssm"], jseg["ssm"])
    _close(_np(ssm["ssm"]), jssm["ssm"], STATE_RTOL)
    _close(_np(ssm["conv"]), jssm["conv"], STATE_RTOL)
    assert ssm["idx"] == int(jssm["idx"][0]) == 13 == c["pos"]


def _steps(vocab, b, c, seed=0):
    """One chunked-prefill step of b rows of c tokens (rows of c, 5 and c
    - 3 valid tokens, and a last row of padding on the null page and
    slot) and two decode steps."""
    rng = np.random.default_rng(seed)
    lengths = np.array([c, 5] + [c - 3] * (b - 3) + [0])
    steps = [(rng.integers(0, vocab, (b, c)).astype(np.int32),
              np.tile(np.arange(c, dtype=np.int32), (b, 1)),
              np.arange(c)[None, :] < lengths[:, None])]
    for t in range(2):
        steps.append((rng.integers(0, vocab, (b, 1)).astype(np.int32),
                      (lengths + t)[:, None].astype(np.int32),
                      (lengths > 0)[:, None]))
    return steps


@pytest.mark.parametrize("cell", list(CELLS))
def test_paged_step_matches_reference(cell):
    """At the pool geometry and batch shapes of a 4-slot engine (max_len
    64), against the step that engine jits: logits of the live rows after
    every step, and every slot pool (the ssd conv tail and state; SRF's
    s and z) and kv page but the null ones at the end."""
    jcfg, jparams, cfg, params, quant = _cell(cell)
    eng = _ref_engine(jcfg, jparams, quant, batch_slots=4, max_len=64)
    sc, n_slots = eng.sched_cfg, eng.sched.num_slots
    b, c, w = sc.max_batch, sc.prefill_chunk, sc.table_width
    assert b == sc.prefill_batch == 4
    jpools = jcache.init_pools(jcfg, sc.num_pages, sc.page_size,
                               num_slots=n_slots,
                               paged=jcache.PagedConfig(quant))
    pools = paged_cache.init_pools(cfg, sc.num_pages, sc.page_size,
                                   num_slots=n_slots, device="cpu",
                                   paged=paged_cache.PagedConfig(quant))
    assert paged_cache.plan_for(cfg).name == jcache.plan_for(jcfg).name
    slots = np.array([1, 3, 4, 0], np.int32)
    tables = np.zeros((b, w), np.int32)
    if eng.plan.has_paged:
        tables[:-1] = np.arange(1, 1 + (b - 1) * w).reshape(b - 1, w)
    for tok, pos, qv in _steps(cfg.vocab, b, c):
        want, jpools = eng._step(jparams, jpools, *map(jnp.asarray, (
            tok, pos, qv, tables, slots)))
        got, pools = T.paged_step(params, cfg, pools, torch.from_numpy(tok),
                                  torch.from_numpy(pos).long(),
                                  torch.from_numpy(qv),
                                  torch.from_numpy(tables).long(),
                                  torch.from_numpy(slots).long())
        live = qv.any(axis=1)
        _close(_np(got)[live], _np(want)[live])
    for part in ("paged", "slot"):
        seg, jseg = pools[part][0], jpools[part][0]
        assert (seg is None) == (jseg is None)
        if seg is None:
            continue
        for comp, leaves in seg.items():
            for k, a in leaves.items():
                rtol = STATE_RTOL if comp == "ssm" else LOGIT_RTOL
                g, w = _np(a)[:, 1:], _np(jseg[comp][k])[:, 1:]
                if a.dtype == torch.int8:
                    np.testing.assert_array_equal(g, w)
                else:
                    _close(g, w, rtol)


def test_full_width_slot_and_page_bytes():
    """The pool plans of the full-width configs, reckoned without
    allocating: mamba2's slot holds 64 x (80·128·64·4 + 3·5376·2) bytes,
    hymba's 32 x (50·16·64·4 + 3·3232·2) plus 40 KB of bf16 KV a token
    (32 layers x 2 x 5 heads x 64 x 2 bytes)."""
    m, h = registry.get("mamba2-2.7b"), registry.get("hymba-1.5b")
    ssd = paged_cache.FAMILIES["ssd"]
    assert paged_cache.plan_for(m).name == "ssd"
    assert paged_cache.plan_for(h).name == "kv+ssd"
    assert paged_cache.plan_for(
        registry.get("hymba-1.5b", attn_impl="srf")).name == "srf+ssd"
    slot = lambda cfg: ssd.bytes_per_token(cfg, 1) * cfg.n_layers  # noqa
    assert slot(m) == 64 * (80 * 128 * 64 * 4 + 3 * 5376 * 2)
    assert slot(h) == 32 * (50 * 16 * 64 * 4 + 3 * 3232 * 2)
    kv = paged_cache.FAMILIES["kv"].bytes_per_token(h, 1) * h.n_layers
    assert kv == 32 * 2 * 5 * 64 * 2 == 40960
    sm = registry.get("seamless-m4t-large-v2")
    plan = paged_cache.plan_for(sm)
    assert (plan.name, plan.has_memory, plan.needs_slot) == \
        ("kv+mem", True, True)
    # the memory slot, amortized over max_len, beside 24 layers' KV
    assert plan.bytes_per_token(sm, 1024) == \
        2 * 16 * 64 * 2 + 1024 * 1024 * 2 / 1024


# ---------------------------------------------------------------------------
# the engines
# ---------------------------------------------------------------------------

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
    done = eng.run()
    for r in done:
        assert r.t_submit <= r.t_first <= r.t_done
        if r.trace is not None:                  # legacy engine: no trace
            assert r.trace.monotonic() and r.trace.count("done") == 1
    return {r.uid: list(r.out_tokens) for r in done}


def _assert_no_leaks(eng):
    sched = eng.sched
    if eng.prefix is not None:
        assert sched.alloc.used_pages == eng.prefix.pages
        assert sched.alloc.total_refs == eng.prefix.pages
        eng.prefix.drop_all()
    assert sched.alloc.used_pages == 0 and sched.alloc.total_refs == 0
    if sched.slot_alloc is not None:
        assert sched.slot_alloc.used_pages == 0


def _reference(cell, n=8, seed=0, temperature=0.0, slots=4):
    """The reference paged engine's tokens on the recipe."""
    jcfg, jparams, _, _, quant = _cell(cell)
    eng = _ref_engine(jcfg, jparams, quant, batch_slots=slots, max_len=64,
                      seed=5)
    return _drive(eng, _requests(jserving.Request, jcfg, n, seed,
                                 temperature))


PARITY = [(cell, t) for cell in CELLS for t in (0.0, 0.8)
          if not (CELLS[cell][2] and t)]


@pytest.mark.parametrize("cell,temperature", PARITY,
                         ids=[f"{c}-{'sampled' if t else 'greedy'}"
                              for c, t in PARITY])
def test_paged_equals_legacy_equals_reference(cell, temperature):
    """8 mixed-length requests, 4 slots: the port's paged tokens equal
    the reference paged engine's and the port's legacy engine's, greedy
    and sampled (temperature 0.8). Int8 pages (greedy): the paged engine
    quantizes per token, the legacy int8 cache (``kv_cache_dtype=
    "int8"``) per token and head, and on hymba the reference's two
    engines part; so the port's paged engine is held to the reference's
    paged engine and its legacy engine to the reference's legacy
    engine (on the recipe's first request)."""
    jcfg, jparams, cfg, params, quant = _cell(cell)
    eng = Engine(cfg, params, batch_slots=4, max_len=64, seed=5,
                 device="cpu", paged=PagedConfig(quant))
    paged = _drive(eng, _requests(Request, cfg, 8, 0, temperature))
    assert len(paged) == 8 and eng.nonfinite_rows == 0
    assert paged == _reference(cell, temperature=temperature)
    _assert_no_leaks(eng)
    assert eng.free_slots == eng.usable_slots
    legacy, jlegacy = _legacy()
    arch, over, _ = CELLS[cell]
    lover = dict(over, **({"kv_cache_dtype": "int8"} if quant else {}))
    leg = legacy.Engine(registry.reduced(arch, n_layers=2, **lover), params,
                        batch_slots=4, max_len=64, seed=5, device="cpu")
    if quant:        # the reference's legacy engine: its first request
        jleg = jlegacy.Engine(jregistry.reduced(arch, n_layers=2, **lover),
                              jparams, batch_slots=4, max_len=64, seed=5)
        assert _drive(leg, _requests(Request, cfg, 8)[:1]) == \
            _drive(jleg, _requests(jserving.Request, jcfg, 8)[:1])
    else:
        assert _drive(leg, _requests(Request, cfg, 8, 0, temperature)) \
            == paged


@pytest.mark.parametrize("cell", ["ssd", "hybrid"])
def test_seeded_sampling_deterministic(cell):
    """tests/test_engine_parity.py:108: two paged runs at one engine
    seed give the same sampled tokens, and another seed changes some."""
    _, _, cfg, params, _ = _cell(cell)

    def run(seed):
        eng = Engine(cfg, params, batch_slots=4, max_len=64, seed=seed,
                     device="cpu")
        return _drive(eng, _requests(Request, cfg, 8, temperature=0.9))
    a, b, c = run(7), run(7), run(8)
    assert len(a) == 8 and a == b and a != c
    assert all(0 <= t < cfg.vocab for toks in a.values() for t in toks)


def test_hybrid_16_concurrent():
    """tests/test_engine_parity.py:146 on the port: 16 concurrent hymba
    requests through 8 slots equal the legacy engine's and the reference
    paged engine's tokens; every page and slot comes back."""
    _, _, cfg, params, _ = _cell("hybrid")
    eng = Engine(cfg, params, batch_slots=8, max_len=64, seed=5,
                 device="cpu")
    paged = _drive(eng, _requests(Request, cfg, 16, seed=3))
    legacy, _ = _legacy()
    leg = legacy.Engine(cfg, params, batch_slots=8, max_len=64, seed=5,
                        device="cpu")
    assert len(paged) == 16
    assert paged == _drive(leg, _requests(Request, cfg, 16, seed=3))
    assert paged == _reference("hybrid", n=16, seed=3, slots=8)
    assert eng.sched.alloc.used_pages == 0
    assert eng.free_slots == eng.usable_slots


def test_hybrid_preemption_restores_both_domains():
    """tests/test_engine_parity.py:163 on the port: a tight page pool
    evicts hybrid sequences mid-decode; the snapshot carries the kv
    pages and the ssd slot state, so the tokens equal the roomy pool's
    and the reference's tight run's."""
    jcfg, jparams, cfg, params, _ = _cell("hybrid")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab, 3).astype(np.int32)
               for _ in range(4)]

    def drive(pkg, c, p, pages):
        sched = pkg.SchedConfig(max_batch=4, prefill_batch=2,
                                prefill_chunk=4, page_size=4,
                                num_pages=pages, table_width=4)
        eng = (_ref_engine if pkg is jserving else partial(
            pkg.Engine, device="cpu"))(c, p, batch_slots=4, max_len=16,
                                       sched=sched)
        out = _drive(eng, [pkg.Request(uid=i, prompt=q.copy(), max_new=10)
                           for i, q in enumerate(prompts)])
        return out, eng.stats["preemptions"]

    import repro_torch.serving as tserving
    tight, n_pre = drive(tserving, cfg, params, 9)
    roomy, _ = drive(tserving, cfg, params, 33)
    ref, ref_pre = drive(jserving, jcfg, jparams, 9)
    assert n_pre > 0, "the pool was not tight enough to preempt"
    assert tight == roomy == ref and n_pre == ref_pre


@pytest.mark.parametrize("cell", ["ssd", "hybrid", "hybrid srf"])
def test_constant_state_zeroed_on_reuse(cell):
    """tests/test_engine_parity.py:196: two waves through one engine (the
    second reuses freed slots) give the second wave a fresh engine's
    tokens."""
    _, _, cfg, params, _ = _cell(cell)
    eng = Engine(cfg, params, batch_slots=4, max_len=64, device="cpu")
    _drive(eng, _requests(Request, cfg, 6, seed=1))
    got = _drive(eng, _requests(Request, cfg, 6, seed=2))
    fresh = Engine(cfg, params, batch_slots=4, max_len=64, device="cpu")
    assert got == _drive(fresh, _requests(Request, cfg, 6, seed=2))


def test_ssd_engine_mixed_lengths():
    """tests/test_paged_serving.py:123 for the ssd plan: 16 requests of
    2-23 prompt tokens through 8 slots all finish with max_new tokens;
    the plan has no page domain and every slot comes back."""
    _, _, cfg, params, _ = _cell("ssd")
    eng = Engine(cfg, params, batch_slots=8, max_len=64, device="cpu")
    assert eng.pools["paged"] == [None]
    assert set(eng.pools["slot"][0]) == {"ssm"}
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
    assert eng.free_slots == eng.usable_slots
    rep = eng.cache_report()
    assert rep["family"] == "ssd"
    assert rep["pool_bytes"] == paged_cache.pool_bytes(eng.pools)


# ---------------------------------------------------------------------------
# the prefix cache
# ---------------------------------------------------------------------------

SCENARIOS = ["hit", "partial", "miss", "evict", "cow"]
PREFIX_COUNTERS = ("prefix_lookups_total", "prefix_hits_total",
                   "prefix_hit_tokens_total", "prefix_cow_forks_total",
                   "prefix_evictions_total", "prefix_inserted_pages_total",
                   "engine_prefill_tokens_total")


def _scenario_waves(cls, cfg, scenario):
    """``test_prefix_serving._scenario_waves``: a donor, then the
    measured wave."""
    rng = np.random.default_rng(0)
    shared = rng.integers(1, cfg.vocab, 36).astype(np.int32)
    tails = [rng.integers(1, cfg.vocab, 3 + i).astype(np.int32)
             for i in range(5)]
    donors = [cls(uid=100, prompt=shared.copy(), max_new=2)]
    if scenario in ("hit", "evict", "cow"):
        wave = [cls(uid=i, prompt=np.concatenate([shared, t]), max_new=6)
                for i, t in enumerate(tails)]
    elif scenario == "partial":
        wave = [cls(uid=i, prompt=np.concatenate([shared[:20], t, t]),
                    max_new=6) for i, t in enumerate(tails)]
    else:
        wave = [cls(uid=i, prompt=rng.integers(1, cfg.vocab, 20 + i)
                    .astype(np.int32), max_new=6) for i in range(5)]
    return donors, wave


def _fresh(reqs, cls=Request):
    return [cls(uid=r.uid, prompt=r.prompt.copy(), max_new=r.max_new)
            for r in reqs]


def _scenario_kw(pkg, scenario):
    kw = dict(batch_slots=4, max_len=64)
    if scenario == "evict":      # a tight pool: admissions evict the cache
        kw["sched"] = pkg.SchedConfig(max_batch=2, prefill_batch=2,
                                      prefill_chunk=16, page_size=8,
                                      num_pages=12, table_width=7)
    return kw


_prefix_runs = {}


def _prefix_scenario(scenario):
    """A scenario's runs on the hybrid cell: the port's cold and warm
    engines and the reference's warm engine, each given the donors and
    then the wave; their tokens, prefix counters and the wave's
    ``prefix_peek`` verdicts (taken before the leak checks drop the
    cache). "cow" is "hit"'s traffic on "hit"'s engines (as in the
    reference's matrix), so the two share one set of runs."""
    key = "hit" if scenario == "cow" else scenario
    if key in _prefix_runs:
        return _prefix_runs[key]
    jcfg, jparams, cfg, params, _ = _cell("hybrid")
    import repro_torch.serving as tserving

    def port(prefix):
        eng = Engine(cfg, params, device="cpu", prefix=prefix,
                     **_scenario_kw(tserving, key))
        donors, wave = _scenario_waves(Request, cfg, key)
        _drive(eng, donors)
        return eng, wave, _drive(eng, wave)
    cold, _, want = port(None)
    _assert_no_leaks(cold)
    warm, wave, got = port(PrefixConfig(chunk=ChunkConfig(chunk_tokens=16)))
    ref = _ref_engine(jcfg, jparams, prefix=jserving.PrefixConfig(
        chunk=jserving.ChunkConfig(chunk_tokens=16)),
        **_scenario_kw(jserving, key))
    jdonors, jwave = _scenario_waves(jserving.Request, jcfg, key)
    _drive(ref, jdonors)
    v, jv = warm.metrics.value_sum, ref.metrics.value_sum
    run = dict(cold=want, warm=got, ref=_drive(ref, jwave),
               counters={c: v(c) for c in PREFIX_COUNTERS},
               ref_counters={c: jv(c) for c in PREFIX_COUNTERS},
               peeks=[warm.prefix_peek(r) for r in _fresh(wave)],
               ref_peeks=[ref.prefix_peek(r)
                          for r in _fresh(wave, jserving.Request)])
    _assert_no_leaks(warm)
    _prefix_runs[key] = run
    return run


@pytest.mark.parametrize("scenario", SCENARIOS)
def test_hybrid_prefix_matrix_matches_cold_and_reference(scenario):
    """tests/test_prefix_serving.py:297 for the hybrid plan: warm tokens
    equal the cold engine's and the reference warm engine's, the prefix
    counters equal the reference's, and nothing leaks. A hit restores
    the donor's slot state (the payload the engine attaches at insert);
    a divergence inside the prompt has no donor state and misses."""
    run = _prefix_scenario(scenario)
    assert run["warm"] == run["cold"] == run["ref"]
    v = run["counters"]
    assert v == run["ref_counters"]
    hit_toks = v["prefix_hit_tokens_total"]
    assert (hit_toks > 0) == (scenario in ("hit", "evict", "cow"))
    if scenario == "miss":
        assert v["prefix_lookups_total"] > 0
    if scenario == "evict":
        assert v["prefix_evictions_total"] > 0
    if scenario == "cow":
        assert v["prefix_cow_forks_total"] > 0
    assert run["peeks"] == run["ref_peeks"]


def test_hybrid_prefix_trace_milestones():
    """tests/test_prefix_serving.py:345 for the hybrid plan: a hit
    request's trace carries ``prefix_hit`` once, a long cold prompt at
    ``chunk_tokens=8`` carries ``chunked_prefill``, and every lifecycle
    stays monotonic."""
    _, _, cfg, params, _ = _cell("hybrid")
    eng = Engine(cfg, params, batch_slots=4, max_len=64, device="cpu",
                 prefix=PrefixConfig(chunk=ChunkConfig(chunk_tokens=8)))
    donors, wave = _scenario_waves(Request, cfg, "hit")
    _drive(eng, donors)
    _drive(eng, wave)
    hits = [r for r in wave if r.trace.count("prefix_hit")]
    assert hits and all(r.trace.count("prefix_hit") == 1
                        and r.trace.monotonic() for r in hits)
    assert any(r.trace.count("chunked_prefill") for r in wave)
    _assert_no_leaks(eng)


def test_prefix_cache_disabled_for_pure_constant_state():
    """tests/test_prefix_serving.py:368: an SSD plan has no pages to
    share, so ``prefix=`` is off and the engine serves."""
    _, _, cfg, params, _ = _cell("ssd")
    eng = Engine(cfg, params, batch_slots=2, max_len=64, device="cpu",
                 prefix=PrefixConfig())
    assert eng.prefix is None
    rng = np.random.default_rng(0)
    out = _drive(eng, [Request(uid=i, prompt=rng.integers(
        1, cfg.vocab, 8).astype(np.int32), max_new=4) for i in range(3)])
    assert all(len(t) == 4 for t in out.values())


# ---------------------------------------------------------------------------
# the serve CLI
# ---------------------------------------------------------------------------

CLI = [("mamba2-2.7b", [], "'family': 'ssd'"),
       ("mamba2-2.7b", ["--legacy"], "engine=legacy"),
       ("hymba-1.5b", [], "'family': 'kv+ssd'"),
       ("hymba-1.5b", ["--quantize-kv"], "'family': 'kv+ssd'"),
       ("hymba-1.5b", ["--attn", "srf"], "'family': 'srf+ssd'"),
       ("hymba-1.5b", ["--legacy"], "engine=legacy"),
       ("hymba-1.5b", ["--prefix-cache", "--shared-prefix", "16"],
        "prefix: hits="),
       ("mamba2-2.7b", ["--replicas", "2", "--ft", "--chaos", "raise@2:1"],
        "'quarantined': 1"),
       ("hymba-1.5b", ["--replicas", "2", "--ft", "--chaos", "raise@2:1"],
        "'quarantined': 1")]


@pytest.mark.parametrize("arch,flags,expect", CLI,
                         ids=[f"{a}{''.join(f)}" for a, f, _ in CLI])
def test_cli_serves_reduced_on_cpu(capsys, arch, flags, expect):
    args = ["--arch", arch, "--reduced", "--device", "cpu", "--requests",
            "3", "--prompt-len", "20", "--max-new", "4", "--slots", "2"]
    assert serve.main(args + flags) == 0
    out = capsys.readouterr().out
    assert "requests=3 tokens=12" in out and expect in out
