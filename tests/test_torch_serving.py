"""The port's serving engine against ``repro.serving.Engine`` on the CPU,
and the port's isolation from jax and the reference package.

Greedy tokens must be IDENTICAL: reduced qwen3-4b with SRF attention and
with full-KV pages (f32, bf16, int8), the reference's params carried
over with ``convert.params_from_jax``, and the mixed-length request
recipe of ``test_engine_parity._requests``. The prefix cache runs the
reference's kv scenarios (``test_prefix_serving``): tokens equal to the
cold engine and to the reference, prefix counters equal to the
reference engine's, no page leaked. Its trie, chunk policy and cache
units are held to the same cases as the reference's.
"""
import ast
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro import serving as jserving
from repro.configs import registry as jregistry
from repro.models import transformer as jT
from repro.serving import Engine as JEngine
from repro.serving import Request as JRequest
from repro_torch import convert
from repro_torch.configs import registry
from repro_torch.launch import serve
from repro_torch.serving import (BlockAllocator, ChunkConfig, Engine,
                                 PagedConfig, PrefixConfig, Request,
                                 SchedConfig)
from repro_torch.serving.prefix import (ChunkPolicy, PrefixCache, RadixTrie,
                                        cow)

ROOT = Path(__file__).resolve().parents[1]


def _requests(cls, cfg, n, seed=0):
    """test_engine_parity._requests's recipe (greedy, no enc-dec)."""
    rng = np.random.default_rng(seed)
    return [cls(uid=i, prompt=rng.integers(0, cfg.vocab, int(
        rng.integers(2, 20))).astype(np.int32),
        max_new=int(rng.integers(3, 7))) for i in range(n)]


def _drive(eng, reqs):
    for r in reqs:
        eng.submit(r)
    done = eng.run()
    for r in done:
        assert r.t_submit <= r.t_first <= r.t_done
        assert r.trace.monotonic() and r.trace.count("done") == 1
    return {r.uid: r.out_tokens for r in done}


_ref_steps = {}


def _jengine(jcfg, jparams, **kw):
    """A reference paged engine. The reference wraps its step in a new
    ``jax.jit`` per engine, so each would compile anew; engines of one
    (config, page layout) here share the first one's jitted step (the
    same function), which keeps its compiled shapes."""
    eng = JEngine(jcfg, jparams, **kw)
    eng._step = _ref_steps.setdefault((eng.cfg, eng.paged), eng._step)
    return eng


def _jinit(jcfg):
    """The reference's params of ``jcfg`` from key 0."""
    return jT.init(jax.random.PRNGKey(0), jcfg)


@pytest.fixture(scope="module")
def models():
    jcfg = jregistry.reduced("qwen3-4b", attn_impl="srf", n_layers=2)
    cfg = registry.reduced("qwen3-4b", attn_impl="srf", n_layers=2)
    jparams = _jinit(jcfg)
    params = convert.params_from_jax(jax.tree.map(np.asarray, jparams), cfg,
                                     device="cpu")
    return jcfg, jparams, cfg, params


def test_greedy_tokens_identical_to_reference(models):
    jcfg, jparams, cfg, params = models
    want = _drive(_jengine(jcfg, jparams, batch_slots=4, max_len=64),
                  _requests(JRequest, jcfg, 8))
    eng = Engine(cfg, params, batch_slots=4, max_len=64, device="cpu")
    got = _drive(eng, _requests(Request, cfg, 8))
    assert len(got) == 8
    assert got == want
    assert eng.nonfinite_rows == 0
    assert eng.free_slots == eng.usable_slots        # every slot returned


def test_constant_state_zeroed_on_reuse(models):
    """A slot re-issued to a later request starts from zero: a second
    wave through the same engine matches a fresh engine."""
    _, _, cfg, params = models
    eng = Engine(cfg, params, batch_slots=4, max_len=64, device="cpu")
    _drive(eng, _requests(Request, cfg, 6, seed=1))
    got = _drive(eng, _requests(Request, cfg, 6, seed=2))
    fresh = Engine(cfg, params, batch_slots=4, max_len=64, device="cpu")
    assert got == _drive(fresh, _requests(Request, cfg, 6, seed=2))


_kv_cache = {}


def _kv_models(dtype="float32"):
    """Reduced 2-layer qwen3-4b with its default full attention, in both
    packages, with the same params."""
    if dtype not in _kv_cache:
        jcfg = jregistry.reduced("qwen3-4b", n_layers=2, dtype=dtype)
        cfg = registry.reduced("qwen3-4b", n_layers=2, dtype=dtype)
        assert cfg.attn_impl == jcfg.attn_impl == "full"
        jparams = _jinit(jcfg)
        params = convert.params_from_jax(jax.tree.map(np.asarray, jparams),
                                         cfg, device="cpu")
        _kv_cache[dtype] = (jcfg, jparams, cfg, params)
    return _kv_cache[dtype]


def _assert_no_leaks(eng):
    """After a drain the only live page references are the cache's;
    dropping it returns the pool to zero used pages."""
    alloc = eng.sched.alloc
    if eng.prefix is not None:
        assert alloc.used_pages == eng.prefix.pages
        assert alloc.total_refs == eng.prefix.pages
        eng.prefix.drop_all()
    assert alloc.used_pages == 0 and alloc.total_refs == 0


@pytest.mark.parametrize("pages", ["float32", "bfloat16", "int8"])
def test_kv_greedy_tokens_identical_to_reference(pages):
    """Full-KV pages: f32 and bf16 models with pages of their own dtype,
    and int8 pages (f32 model, ``PagedConfig(quantize_kv=True)``)."""
    quant = pages == "int8"
    jcfg, jparams, cfg, params = _kv_models("float32" if quant else pages)
    want = _drive(_jengine(jcfg, jparams, batch_slots=4, max_len=64,
                           paged=jserving.PagedConfig(quantize_kv=quant)),
                  _requests(JRequest, jcfg, 8))
    eng = Engine(cfg, params, batch_slots=4, max_len=64, device="cpu",
                 paged=PagedConfig(quantize_kv=quant))
    got = _drive(eng, _requests(Request, cfg, 8))
    assert len(got) == 8 and got == want
    assert eng.plan.name == "kv" and eng.nonfinite_rows == 0
    leaf = eng.pools["paged"][0]["attn"]["k"]
    assert leaf.dtype == (torch.int8 if quant else getattr(torch, pages))
    _assert_no_leaks(eng)


@pytest.mark.parametrize("quantize_kv", [False, True])
def test_kv_preemption_restores_pages(quantize_kv):
    """A tight pool forces copy-on-preempt mid-decode (pages snapshotted
    to host memory, restored at re-admission); the tokens equal the
    roomy pool's and the reference engine's under the same tight pool
    (``test_paged_serving.test_preemption_restores_state``)."""
    jcfg, jparams, cfg, params = _kv_models()
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab, 3).astype(np.int32)
               for _ in range(4)]
    geo = dict(max_batch=4, prefill_batch=2, prefill_chunk=4, page_size=4,
               table_width=4)

    def drive(eng, cls):
        out = _drive(eng, [cls(uid=i, prompt=p, max_new=10)
                           for i, p in enumerate(prompts)])
        return out, eng.stats["preemptions"]

    def port(num_pages):
        return Engine(cfg, params, batch_slots=4, max_len=16, device="cpu",
                      sched=SchedConfig(num_pages=num_pages, **geo),
                      paged=PagedConfig(quantize_kv=quantize_kv))
    tight = port(9)
    out_tight, n_pre = drive(tight, Request)
    out_roomy, _ = drive(port(33), Request)
    want, j_pre = drive(_jengine(
        jcfg, jparams, batch_slots=4, max_len=16,
        sched=jserving.SchedConfig(num_pages=9, **geo),
        paged=jserving.PagedConfig(quantize_kv=quantize_kv)), JRequest)
    assert n_pre > 0, "pool was not tight enough to force preemption"
    assert n_pre == j_pre
    assert out_tight == out_roomy == want
    _assert_no_leaks(tight)


SCENARIOS = ["hit", "partial", "miss", "evict", "cow"]
PREFIX_COUNTERS = ("prefix_lookups_total", "prefix_hits_total",
                   "prefix_hit_tokens_total", "prefix_cow_forks_total",
                   "prefix_evictions_total", "prefix_inserted_pages_total",
                   "engine_prefill_tokens_total")


def _scenario_waves(cls, cfg, scenario):
    """``test_prefix_serving._scenario_waves`` for the kv family: a donor
    wave, then the measured wave."""
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


def _scenario_kw(pkg, scenario):
    kw = dict(batch_slots=4, max_len=64)
    if scenario == "evict":      # a tight pool: admissions evict the cache
        kw["sched"] = pkg.SchedConfig(max_batch=2, prefill_batch=2,
                                      prefill_chunk=16, page_size=8,
                                      num_pages=12, table_width=7)
    return kw


_prefix_runs = {}


def _prefix_scenario(scenario):
    """A scenario's runs: the port's cold and warm engines and the
    reference's warm engine, each given the donors and then the wave;
    their tokens and prefix counters, the engines checked for leaks.
    "cow" is "hit"'s traffic on "hit"'s engines (as in the reference's
    matrix), so the two share one set of runs."""
    key = "hit" if scenario == "cow" else scenario
    if key in _prefix_runs:
        return _prefix_runs[key]
    jcfg, jparams, cfg, params = _kv_models()
    import repro_torch.serving as tserving

    def port(prefix):
        eng = Engine(cfg, params, device="cpu", prefix=prefix,
                     **_scenario_kw(tserving, key))
        donors, wave = _scenario_waves(Request, cfg, key)
        _drive(eng, donors)
        return eng, _drive(eng, wave)
    cold, want = port(None)
    _assert_no_leaks(cold)
    warm, got = port(PrefixConfig(chunk=ChunkConfig(chunk_tokens=16)))
    ref = _jengine(jcfg, jparams, prefix=jserving.PrefixConfig(
        chunk=jserving.ChunkConfig(chunk_tokens=16)),
        **_scenario_kw(jserving, key))
    donors, wave = _scenario_waves(JRequest, jcfg, key)
    _drive(ref, donors)
    v, jv = warm.metrics.value_sum, ref.metrics.value_sum
    run = dict(cold=want, warm=got, ref=_drive(ref, wave),
               counters={c: v(c) for c in PREFIX_COUNTERS},
               ref_counters={c: jv(c) for c in PREFIX_COUNTERS})
    _assert_no_leaks(warm)
    _prefix_runs[key] = run
    return run


@pytest.mark.parametrize("scenario", SCENARIOS)
def test_prefix_scenarios_match_cold_and_reference(scenario):
    run = _prefix_scenario(scenario)
    assert run["warm"] == run["cold"] == run["ref"]
    v = run["counters"]
    assert v == run["ref_counters"]
    assert (v["prefix_hit_tokens_total"] > 0) == (scenario != "miss")
    if scenario == "evict":
        assert v["prefix_evictions_total"] > 0
    if scenario == "cow":
        assert v["prefix_cow_forks_total"] > 0


def test_prefix_cache_disabled_for_pure_constant_state(models):
    """An SRF plan has no pages to share: ``prefix=`` is silently off."""
    _, _, cfg, params = models
    eng = Engine(cfg, params, batch_slots=2, max_len=64, device="cpu",
                 prefix=PrefixConfig())
    assert eng.prefix is None and eng.prefix_peek(
        Request(uid=0, prompt=np.arange(4, dtype=np.int32))) == 0
    out = _drive(eng, _requests(Request, cfg, 3))
    assert len(out) == 3


def test_exact_duplicate_prompt_hits_and_matches():
    """plen-1 cap: an exact duplicate shares every full page below the
    cap and re-prefills the last token for its own first logits."""
    _, _, cfg, params = _kv_models()
    prompt = np.random.default_rng(3).integers(1, cfg.vocab, 33).astype(
        np.int32)

    def run(prefix):
        eng = Engine(cfg, params, batch_slots=2, max_len=64, device="cpu",
                     prefix=prefix)
        a = _drive(eng, [Request(uid=0, prompt=prompt.copy(), max_new=6)])
        assert eng.prefix_peek(Request(uid=1, prompt=prompt.copy())) == \
            (32 if prefix else 0)
        b = _drive(eng, [Request(uid=1, prompt=prompt.copy(), max_new=6)])
        if prefix is not None:
            assert eng.metrics.value_sum("prefix_hit_tokens_total") == 32
            _assert_no_leaks(eng)
        return a[0], b[1]

    assert run(None) == run(PrefixConfig())


def test_defrag_keeps_tokens(monkeypatch):
    """Compacting live pages mid-serve moves their rows with them: the
    tokens equal an undisturbed run's and every page comes back."""
    from repro_torch.serving import paged_cache
    _, _, cfg, params = _kv_models()
    moved = []
    apply = paged_cache.apply_moves
    monkeypatch.setattr(paged_cache, "apply_moves", lambda pools, m: (
        moved.append(dict(m)), apply(pools, m))[1])

    def run(defrag):
        eng = Engine(cfg, params, batch_slots=4, max_len=64, device="cpu")
        reqs = _requests(Request, cfg, 8, seed=4)
        for r in reqs:
            eng.submit(r)
        for step in range(12):
            eng.step()
            if defrag and step in (5, 9):
                eng.defrag()
        eng.run()
        assert eng.free_pages == eng.usable_pages
        return {r.uid: r.out_tokens for r in reqs}
    assert run(True) == run(False)
    assert any(moved), "defrag moved no page"


# -- prefix units (test_prefix_serving.py's trie, cache, COW, chunk cases) --

def test_trie_nesting_and_divergence():
    t = RadixTrie(page_size=4)
    new, node = t.insert(0, [1, 2, 3, 4, 5, 6], [10, 11])
    assert new == [10, 11] and node.key == (5, 6)
    new2, _ = t.insert(0, [1, 2, 3, 4, 9, 9], [10, 12])
    assert new2 == [12]
    assert t.n_nodes == 3
    m = t.walk(0, [1, 2, 3, 4, 5, 6, 7, 8])
    assert m.tokens == 6 and m.pages == [10] and m.boundary_page == 11
    m = t.walk(0, [1, 2, 9, 9])
    assert m.tokens == 2 and m.pages == [] and m.boundary_page == 10
    assert t.walk(7, [1, 2, 3, 4]).tokens == 0


def test_trie_insert_page_count_validated():
    t = RadixTrie(page_size=4)
    with pytest.raises(ValueError):
        t.insert(0, [1, 2, 3, 4, 5], [10])
    with pytest.raises(ValueError):
        t.insert(0, [], [])


def test_trie_remove_leaf_only_and_remap():
    t = RadixTrie(page_size=2)
    t.insert(0, [1, 2, 3], [5, 6])
    (inner, leaf) = (t.walk(0, [1, 2, 3]).nodes)
    with pytest.raises(ValueError):
        t.remove(inner)
    assert t.remove(leaf) == 6
    assert t.n_nodes == 1
    t.remap({5: 9})
    assert t.walk(0, [1, 2]).pages == [9]


def test_trie_lru_order_and_pinning():
    alloc = BlockAllocator(num_pages=8, page_size=2)
    cache = PrefixCache(alloc, page_size=2, page_bytes=16)
    pa = alloc.alloc(1)
    pb = alloc.alloc(1)
    cache.insert(0, [1, 2], pa)
    cache.insert(0, [3, 4], pb)
    alloc.free(pa)
    alloc.free(pb)
    m = cache.lookup(0, [3, 4, 5])       # pins pb (refcount 2)
    assert m is not None and m.tokens == 2
    cache.trie.walk(0, [1, 2])           # touch pa: pinned pb is now LRU
    assert cache.evict_for(1) == 1       # evicts unpinned pa, not pb
    assert cache.trie.walk(0, [3, 4]).tokens == 2
    assert cache.trie.walk(0, [1, 2]).tokens == 0
    cache.release(m)
    _ = cache.evict_for(1)
    assert alloc.used_pages == 0


def test_cache_byte_budget_lru():
    alloc = BlockAllocator(num_pages=16, page_size=2)
    cache = PrefixCache(alloc, page_size=2, page_bytes=100,
                        cfg=PrefixConfig(cache_bytes=250))
    for toks in ([1, 2], [3, 4], [5, 6]):
        pg = alloc.alloc(1)
        cache.insert(7, toks, pg)
        alloc.free(pg)
    assert cache.pages == 2 and cache.bytes <= 250
    assert cache.trie.walk(7, [1, 2]).tokens == 0
    assert cache.trie.walk(7, [5, 6]).tokens == 2


def test_cow_plan_match_and_decode_fork_index():
    t = RadixTrie(page_size=4)
    t.insert(0, list(range(10)), [3, 4, 5])
    raw = t.walk(0, list(range(10)))
    shared, fork = cow.plan_match(raw.nodes, 9, page_size=4)
    assert shared == [3, 4] and fork == 5
    shared, fork = cow.plan_match(raw.nodes, 8, page_size=4)
    assert shared == [3, 4] and fork is None
    a = BlockAllocator(num_pages=8, page_size=4)
    (pg,) = a.alloc(1)
    assert cow.decode_fork_index(a, [pg], 2, 4) is None
    a.share([pg])
    assert cow.decode_fork_index(a, [pg], 2, 4) == 0
    with pytest.raises(AssertionError):
        cow.assert_writable(a, [pg], 0, 4, 4)
    a.free([pg])
    cow.assert_writable(a, [pg], 0, 4, 4)


def test_chunk_policy_decode_cadence_and_budget():
    pol = ChunkPolicy(ChunkConfig(chunk_tokens=6, decode_every=3))
    turns = [pol.decode_turn() for _ in range(6)]
    assert turns == [False, False, True, False, False, True]
    assert ChunkPolicy(ChunkConfig(decode_every=0)).decode_turn() is False

    class S:
        def __init__(self, plen, pos):
            self.prompt_len, self.prefill_pos = plen, pos
    work = [S(20, 0), S(20, 16), S(8, 0)]
    plan = ChunkPolicy(ChunkConfig(chunk_tokens=6)).plan(
        work, per_row=8, max_rows=4)
    assert [(id(s), n) for s, n in plan] == [(id(work[0]), 6)]
    plan = ChunkPolicy(ChunkConfig(chunk_tokens=10)).plan(
        work, per_row=8, max_rows=4)
    assert [n for _, n in plan] == [8, 2]
    plan = ChunkPolicy(ChunkConfig(chunk_tokens=1)).plan(
        work, per_row=8, max_rows=4)
    assert [n for _, n in plan] == [1]


def test_unported_requests_are_refused(models):
    """What the port does not serve yet is refused: enc-dec requests and
    mesh-sharded pools. Sampled requests, embed seeds and live quality
    probes are served (``test_torch_sampling``, ``test_torch_seeded``,
    the quality tests below)."""
    _, _, cfg, params = models
    eng = Engine(cfg, params, batch_slots=2, max_len=64, device="cpu")
    prompt = np.arange(3, dtype=np.int32)
    with pytest.raises(NotImplementedError, match="enc-dec"):
        eng.submit(Request(uid=0, prompt=prompt,
                           enc_emb=np.zeros((4, 8), np.float32)))
    eng.submit(Request(uid=1, prompt=prompt, temperature=0.8))
    eng.submit(Request(uid=2, prompt=prompt, embed_seed=7))
    Engine(cfg, params, device="cpu", quality_every=64)
    with pytest.raises(NotImplementedError):
        Engine(cfg, params, device="cpu", mesh=object())


def _quality(eng):
    """{stat: value} of an engine's srf_quality gauge."""
    g = eng.metrics.snapshot()["gauges"].get("srf_quality", {})
    return {k.split('stat="')[1].rstrip('"'): v for k, v in g.items()}


def test_engine_quality_gauge_matches_reference(models):
    """Both engines at quality_every=2 on the same params publish the
    same srf_quality gauge (within 1e-5); a tolerance the stats exceed
    raises quality_drift events, one per sample."""
    jcfg, jparams, cfg, params = models
    reqs = lambda cls: [cls(uid=0, prompt=np.arange(4, dtype=np.int32),  # noqa
                            max_new=6)]
    jeng = _jengine(jcfg, jparams, batch_slots=2, max_len=64,
                    quality_every=2)
    eng = Engine(cfg, params, batch_slots=2, max_len=64, device="cpu",
                 quality_every=2)
    _drive(jeng, reqs(JRequest))
    _drive(eng, reqs(Request))
    got, want = _quality(eng), _quality(jeng)
    assert set(got) == set(want) == {"srf_row_mean_abs_max",
                                     "srf_row_var_err_max"}
    for k in got:
        assert got[k] == pytest.approx(want[k], abs=1e-5), k
    drift = Engine(cfg, params, batch_slots=2, max_len=64, device="cpu",
                   quality_every=2, quality_tol=0.0)
    _drive(drift, reqs(Request))
    events = [e for e in drift.metrics.events if e["event"] == "quality_drift"]
    steps = int(drift.stats["decode_steps"])
    assert len(events) == (steps + 1) // 2 and events[0]["tol"] == 0.0
    assert not [e for e in eng.metrics.events
                if e["event"] == "quality_drift"]


def test_engine_publishes_quality_gauge():
    """``tests/test_obs.py:test_engine_publishes_quality_gauge`` on the
    port, which defaults to quality_every=64 as the reference does and
    publishes at the first decode step; a full-KV engine never
    samples."""
    from repro_torch.models import transformer as T
    cfg = registry.reduced("qwen3-4b", n_layers=2, attn_impl="srf")
    params = T.init(cfg, seed=0, device="cpu")
    eng = Engine(cfg, params, batch_slots=2, max_len=64, device="cpu",
                 quality_every=2)
    eng.submit(Request(uid=0, prompt=np.arange(4, dtype=np.int32),
                       max_new=6))
    eng.run()
    qual = eng.metrics.snapshot()["gauges"].get("srf_quality", {})
    assert qual, "srf engine never sampled the quality gauge"
    assert all(np.isfinite(v) for v in qual.values())
    default = Engine(cfg, params, batch_slots=2, max_len=64, device="cpu")
    assert default._quality_every == 64
    _drive(default, [Request(uid=0, prompt=np.arange(4, dtype=np.int32),
                             max_new=3)])
    assert _quality(default)
    kv = registry.reduced("qwen3-4b", n_layers=2)
    kv_eng = Engine(kv, T.init(kv, seed=0, device="cpu"), batch_slots=2,
                    max_len=64, device="cpu", quality_every=1)
    _drive(kv_eng, [Request(uid=0, prompt=np.arange(4, dtype=np.int32),
                            max_new=3)])
    assert not _quality(kv_eng)


def test_cli_quality_flags():
    """``--quality-every`` (default 64, as the reference CLI) and
    ``--quality-tol`` reach the engine."""
    from repro_torch.obs import quality
    base = ["--arch", "qwen3-4b", "--attn", "srf", "--reduced", "--device",
            "cpu", "--requests", "2", "--prompt-len", "5", "--max-new", "3"]
    args = serve.parser().parse_args(base)
    assert (args.quality_every, args.quality_tol) == (64, quality.DRIFT_TOL)
    res = serve.serve(serve.parser().parse_args(
        base + ["--quality-every", "1", "--quality-tol", "0"]))
    eng = res["engine"]
    assert eng._quality_every == 1 and _quality(eng)
    assert [e for e in eng.metrics.events if e["event"] == "quality_drift"]
    off = serve.serve(serve.parser().parse_args(
        base + ["--quality-every", "0"]))
    assert not _quality(off["engine"])


def test_cli_full_width_by_default_and_reduced_opt_in(capsys):
    assert serve.parser().parse_args(["--arch", "qwen3-4b"]).reduced is False
    assert serve.main(["--arch", "qwen3-4b", "--attn", "srf", "--reduced",
                       "--device", "cpu", "--requests", "3",
                       "--prompt-len", "5", "--max-new", "4"]) == 0
    out = capsys.readouterr().out
    assert "requests=3 tokens=12" in out and "reduced=True" in out


@pytest.mark.parametrize("flags,family", [
    ([], "'family': 'kv'"), (["--quantize-kv"], "'family': 'kv'"),
    (["--prefix-cache", "--shared-prefix", "16"], "prefix: hits=")])
def test_cli_without_attn_serves_full_kv(capsys, flags, family):
    """No ``--attn``: the config's own ``full`` attention, on KV pages
    (int8 with ``--quantize-kv``; the prefix cache with its flags)."""
    args = ["--arch", "qwen3-4b", "--reduced", "--device", "cpu",
            "--requests", "3", "--prompt-len", "20", "--max-new", "4",
            "--slots", "2"] + flags
    parsed = serve.parser().parse_args(args)
    eng = serve.engine(parsed, *serve.build(parsed))
    assert eng.plan.name == "kv"
    assert (eng.pools["paged"][0]["attn"]["k"].dtype == torch.int8) == \
        ("--quantize-kv" in flags)
    assert (eng.prefix is not None) == ("--prefix-cache" in flags)
    assert serve.main(args) == 0
    out = capsys.readouterr().out
    assert "attn=full" in out and "requests=3 tokens=12" in out
    assert family in out


def test_import_loads_neither_jax_nor_reference():
    code = ("import sys, repro_torch.launch.serve, repro_torch.convert, "
            "repro_torch.launch.train, repro_torch.launch.profile_train, "
            "repro_torch.serving.chaos, repro_torch.serving.mesh, "
            "repro_torch.models.ssm, repro_torch.models.moe; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro')]; print(bad); sys.exit(bool(bad))")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         env={"PYTHONPATH": str(ROOT / "src"),
                              "PATH": "/usr/bin:/bin"},
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr


def _imported_roots(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_port_sources_import_no_jax_and_no_reference():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + \
        [ROOT / "chip_smoke.py"]
    assert len(files) > 20
    bad = {str(f.relative_to(ROOT)): sorted(set(_imported_roots(f)) & {
        "jax", "jaxlib", "repro"}) for f in files}
    assert not {f: b for f, b in bad.items() if b}
