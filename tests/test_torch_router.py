"""The port's request router (``serving/mesh/router.py``) against the
reference's on the CPU: placement, migration, pressure and the
snapshot-geometry rule, with no mesh (the reference's own router tests
in ``tests/test_mesh_serving.py`` and ``tests/test_prefix_serving.py``
run on one device too).

Reduced qwen3-4b (2 layers, f32), the reference's params carried over
with ``convert.params_from_jax``. Each scenario runs on both packages:
``submit``'s return values, the router's ``home`` map, its migration
count and the greedy tokens must be equal.
"""
import itertools

import jax
import numpy as np
import pytest
import torch

from repro import serving as jserving
from repro.configs import registry as jregistry
from repro.models import transformer as jT
from repro.obs import MetricsRegistry as JMetricsRegistry
from repro.serving import chaos as jchaos
from repro_torch import convert
from repro_torch.configs import registry
from repro_torch.obs import MetricsRegistry
from repro_torch.serving import (Engine, FTConfig, PagedConfig,
                                 PrefixConfig, Request, Router,
                                 RouterConfig, SchedConfig)
from repro_torch.serving.chaos import ChaosEngine, ChaosPlan

# one intra-op thread: the suite's pytest-xdist workers share the
# cores, and oversubscribed OpenMP pools spin against each other
torch.set_num_threads(1)

_models = {}


def _pair(**over):
    """(jcfg, jparams, cfg, params) for reduced 2-layer qwen3-4b with
    ``over`` (cached)."""
    key = tuple(sorted(over.items()))
    if key not in _models:
        jcfg = jregistry.reduced("qwen3-4b", n_layers=2, **over)
        cfg = registry.reduced("qwen3-4b", n_layers=2, **over)
        jparams = jT.init(jax.random.PRNGKey(0), jcfg)
        params = convert.params_from_jax(jax.tree.map(np.asarray, jparams),
                                         cfg, device="cpu")
        _models[key] = (jcfg, jparams, cfg, params)
    return _models[key]


_ref_steps = {}


class _Side:
    """One package's names and its (cfg, params), so one scenario runs on
    either."""

    def __init__(self, port, **over):
        jcfg, jparams, cfg, params = _pair(**over)
        if port:
            self.cfg, self.params, self.kw = cfg, params, {"device": "cpu"}
            self.Engine, self.Request, self.Router = Engine, Request, Router
            self.RouterConfig, self.SchedConfig = RouterConfig, SchedConfig
            self.PagedConfig, self.PrefixConfig = PagedConfig, PrefixConfig
            self.FTConfig, self.Registry = FTConfig, MetricsRegistry
            self.ChaosEngine, self.ChaosPlan = ChaosEngine, ChaosPlan
        else:
            self.cfg, self.params, self.kw = jcfg, jparams, {}
            self.Engine, self.Request = jserving.Engine, jserving.Request
            self.Router = jserving.Router
            self.RouterConfig = jserving.RouterConfig
            self.SchedConfig = jserving.SchedConfig
            self.PagedConfig = jserving.PagedConfig
            self.PrefixConfig = jserving.PrefixConfig
            self.FTConfig, self.Registry = jserving.FTConfig, JMetricsRegistry
            self.ChaosEngine = jchaos.ChaosEngine
            self.ChaosPlan = jchaos.ChaosPlan

    def engine(self, **kw):
        eng = self.Engine(self.cfg, self.params, **kw, **self.kw)
        if self.Engine is jserving.Engine:
            # the reference wraps its step in a new jax.jit per engine:
            # engines of one (config, page layout) share the first one's
            eng._step = _ref_steps.setdefault((eng.cfg, eng.paged),
                                              eng._step)
        return eng


def _both(**over):
    return _Side(True, **over), _Side(False, **over)


def _tight(side, max_batch=1):
    return side.SchedConfig(max_batch=max_batch, prefill_batch=1,
                            prefill_chunk=8, page_size=8, num_pages=3,
                            table_width=2)


def _tokens(reqs):
    return {r.uid: list(r.out_tokens) for r in reqs}


def _prompts(seed, n=5):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 512, int(rng.integers(3, 12))).astype(np.int32)
            for _ in range(n)]


# ---------------------------------------------------------------------------
# tests/test_mesh_serving.py's router cases, on both packages
# ---------------------------------------------------------------------------

def _spreads(side):
    engines = [side.engine(batch_slots=4, max_len=64) for _ in range(2)]
    router = side.Router(engines)
    homes = [router.submit(side.Request(
        uid=i, prompt=np.arange(1, 6, dtype=np.int32), max_new=4))
        for i in range(8)]
    done = router.run()
    return homes, dict(router.home), _tokens(done), engines


def test_router_spreads_by_free_page_pressure():
    port, ref = _both()
    homes, home, toks, engines = _spreads(port)
    assert set(homes) == {0, 1}                  # both replicas used
    assert (homes, home, toks) == _spreads(ref)[:3]
    assert len(toks) == 8
    assert all(e.stats["requests"] > 0 for e in engines)


def _migrates(side):
    roomy = side.SchedConfig(max_batch=4, prefill_batch=4, prefill_chunk=8,
                             page_size=8, num_pages=33, table_width=2)
    e0, e1 = side.engine(sched=_tight(side)), side.engine(sched=roomy)
    router = side.Router([e0, e1], side.RouterConfig(migrate=True))
    # straight into replica 0's queue: a local backlog, as if the
    # pressure estimate had been stale
    for i in range(5):
        e0.submit(side.Request(uid=i, prompt=np.arange(1, 7, dtype=np.int32),
                               max_new=4))
        router.home[i] = 0
    done = router.run()
    return router.stats["migrations"], dict(router.home), _tokens(done), e1


def test_router_migrates_waiting_off_saturated_replica():
    port, ref = _both()
    migrations, home, toks, e1 = _migrates(port)
    assert migrations > 0
    assert e1.stats["requests"] > 0              # migrated work really ran
    assert len(toks) == 5 and all(len(t) == 4 for t in toks.values())
    assert (migrations, home, toks) == _migrates(ref)[:3]


def _migrated_vs_solo(side):
    prompts = _prompts(3)
    solo = side.engine(batch_slots=4, max_len=64)
    for i, p in enumerate(prompts):
        solo.submit(side.Request(uid=i, prompt=p.copy(), max_new=5))
    want = _tokens(solo.run())
    e0 = side.engine(sched=_tight(side))
    e1 = side.engine(batch_slots=4, max_len=64)
    router = side.Router([e0, e1])
    for i, p in enumerate(prompts):
        e0.submit(side.Request(uid=i, prompt=p.copy(), max_new=5))
        router.home[i] = 0
    got = _tokens(router.run())
    return want, got, router.stats["migrations"], dict(router.home)


def test_migrated_outputs_match_unmigrated():
    port, ref = _both()
    want, got, migrations, home = _migrated_vs_solo(port)
    assert migrations > 0
    assert got == want
    assert (want, got, migrations, home) == _migrated_vs_solo(ref)


def _passthrough(side):
    prompts = _prompts(5)
    solo = side.engine(batch_slots=4, max_len=64)
    for i, p in enumerate(prompts):
        solo.submit(side.Request(uid=i, prompt=p.copy(), max_new=5))
    want = _tokens(solo.run())
    router = side.Router([side.engine(batch_slots=4, max_len=64)])
    homes = [router.submit(side.Request(uid=i, prompt=p.copy(), max_new=5))
             for i, p in enumerate(prompts)]
    got = _tokens(router.run())
    return want, got, homes, router


def test_router_single_replica_is_passthrough():
    port, ref = _both()
    want, got, homes, router = _passthrough(port)
    assert got == want
    assert set(router.home.values()) == {0} and homes == [0] * 5
    assert router.stats["migrations"] == 0
    assert router.migrate() == 0                 # no-op fast path
    assert (want, got) == _passthrough(ref)[:2]


def _saturated(side):
    engines = [side.engine(sched=_tight(side)) for _ in range(2)]
    router = side.Router(engines)
    prompt = np.arange(1, 7, dtype=np.int32)
    for i in range(8):                   # a 4-deep backlog on each replica
        engines[i % 2].submit(side.Request(uid=i, prompt=prompt.copy(),
                                           max_new=4))
        router.home[i] = i % 2
    for e in engines:                    # admit the head of each queue
        e.sched.admit()
    heads = [router._headroom(e) for e in engines]
    moved = router.migrate()
    return heads, moved, _tokens(router.run())


def test_router_all_replicas_saturated_no_thrash():
    port, ref = _both()
    heads, moved, toks = _saturated(port)
    assert all(h < 0 for h in heads)     # both saturated
    assert moved == 0                    # symmetric pressure: no move
    assert len(toks) == 8 and all(len(t) == 4 for t in toks.values())
    assert (heads, moved, toks) == _saturated(ref)


def _zero_free(side):
    tight = side.SchedConfig(max_batch=2, prefill_batch=1, prefill_chunk=8,
                             page_size=8, num_pages=3, table_width=2)
    e0 = side.engine(sched=tight)
    e1 = side.engine(batch_slots=4, max_len=64)
    router = side.Router([e0, e1])
    # 9 prompt tokens take both usable pages of replica 0
    e0.submit(side.Request(uid=0, prompt=np.arange(1, 10, dtype=np.int32),
                           max_new=4))
    router.home[0] = 0
    e0.sched.admit()
    free = e0.free_pages
    idx = router.submit(side.Request(uid=1,
                                     prompt=np.arange(1, 6, dtype=np.int32),
                                     max_new=4))
    return free, idx, _tokens(router.run())


def test_router_skips_replica_with_zero_free_pages():
    port, ref = _both()
    free, idx, toks = _zero_free(port)
    assert free == 0
    assert idx == 1                      # the full replica is skipped
    assert len(toks) == 2
    assert (free, idx, toks) == _zero_free(ref)


# ---------------------------------------------------------------------------
# tests/test_prefix_serving.py's router cases
# ---------------------------------------------------------------------------

def _assert_no_leaks(eng):
    alloc = eng.sched.alloc
    if eng.prefix is not None:
        assert alloc.used_pages == eng.prefix.pages
        assert alloc.total_refs == eng.prefix.pages
        eng.prefix.drop_all()
    assert alloc.used_pages == 0 and alloc.total_refs == 0


def _shared_prefix_chaos(side):
    rng = np.random.default_rng(0)
    shared = rng.integers(1, side.cfg.vocab, 36).astype(np.int32)
    blue = [np.concatenate([shared, rng.integers(1, side.cfg.vocab, 3 + i)
                            .astype(np.int32)]) for i in range(8)]

    def mk():
        return [side.Request(uid=i, prompt=p.copy(), max_new=8)
                for i, p in enumerate(blue)]
    ref = side.engine(batch_slots=2, max_len=64)
    want = mk()
    for r in want:
        ref.submit(r)
    ref.run()
    reg = side.Registry()
    inner = [side.engine(batch_slots=2, max_len=64, seed=i, metrics=reg,
                         prefix=side.PrefixConfig()) for i in range(2)]
    for e in inner:                  # a step clock that advances 5 ms a
        ticks = itertools.count()    # read: no wall-time watchdog race
        e.clock = lambda ticks=ticks: 0.005 * next(ticks)
    engines = [inner[0], side.ChaosEngine(inner[1],
                                          side.ChaosPlan("raise", at_step=6))]
    router = side.Router(engines, cfg=side.RouterConfig(migrate=False),
                         metrics=reg,
                         ft=side.FTConfig(grace_steps=2, stuck_rounds=3))
    reqs = mk()
    for r in reqs:
        router.submit(r)
    router.run()
    counts = {k: reg.value_sum(k) for k in (
        "router_quarantined_total", "router_replayed_total",
        "router_rescued_total", "prefix_hit_tokens_total")}
    return _tokens(want), reqs, counts, inner


def test_chaos_kill_replica_with_shared_prefixes_leaks_nothing():
    """A replica killed mid-decode while its cache lends pages to running
    requests: the rescued requests replay on the survivor (attaching
    through its cache) with the undisturbed tokens, the counters equal
    the reference router's, and neither replica leaks a page."""
    port, ref = _both()
    want, reqs, counts, inner = _shared_prefix_chaos(port)
    jwant, jreqs, jcounts, _ = _shared_prefix_chaos(ref)
    assert all(r.done and r.finish_reason in ("eos", "length")
               for r in reqs)
    assert _tokens(reqs) == want == jwant == _tokens(jreqs)
    assert counts == jcounts
    assert counts["router_quarantined_total"] == 1
    assert counts["prefix_hit_tokens_total"] > 0
    for eng in inner:
        _assert_no_leaks(eng)


def _affinity(side):
    rng = np.random.default_rng(1)
    shared = rng.integers(1, side.cfg.vocab, 36).astype(np.int32)
    engines = [side.engine(batch_slots=2, max_len=64, seed=i,
                           prefix=side.PrefixConfig()) for i in range(2)]
    router = side.Router(engines, cfg=side.RouterConfig(migrate=False))
    # warm both caches with equal page counts (equal raw headroom); only
    # replica 1 holds this prompt's prefix
    other = rng.integers(1, side.cfg.vocab, 36).astype(np.int32)
    engines[0].submit(side.Request(uid=49, prompt=other, max_new=2))
    engines[0].run()
    engines[1].submit(side.Request(uid=50, prompt=shared.copy(), max_new=2))
    engines[1].run()
    peek = engines[1].prefix_peek(side.Request(uid=51, prompt=shared.copy(),
                                               max_new=2))
    tail = rng.integers(1, side.cfg.vocab, 4).astype(np.int32)
    req = side.Request(uid=0, prompt=np.concatenate([shared, tail]),
                       max_new=4)
    dest = router.submit(req)
    router.run()
    return peek, dest, list(req.out_tokens), engines


def test_router_prefers_prefix_affinity():
    port, ref = _both()
    peek, dest, toks, engines = _affinity(port)
    assert peek > 0 and dest == 1
    assert (peek, dest, toks) == _affinity(ref)[:3]
    for eng in engines:
        _assert_no_leaks(eng)


# ---------------------------------------------------------------------------
# pressure: free_fraction, headroom, the snapshot-geometry rule
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("cell", ["kv", "int8", "srf"])
def test_free_fraction_and_headroom_match_reference(cell):
    """``Engine.free_fraction`` and the router's headroom equal the
    reference's through a run: empty, after submits, after admission and
    at every later step."""
    over = {"attn_impl": "srf"} if cell == "srf" else {}
    sides = _both(**over)

    def trace(side):
        eng = side.engine(batch_slots=2, max_len=64,
                          paged=side.PagedConfig(
                              quantize_kv=cell == "int8"))
        router = side.Router([eng])
        seen = [(eng.free_fraction, router.pressure())]
        for i, p in enumerate(_prompts(2, 5)):
            eng.submit(side.Request(uid=i, prompt=p.copy(), max_new=6))
        seen.append((eng.free_fraction, router.pressure()))
        while eng.sched.has_work:
            eng.step()
            seen.append((eng.free_fraction, router.pressure()))
        return seen
    got, want = trace(sides[0]), trace(sides[1])
    assert got == want
    assert min(f for f, _ in got) < 1.0 and got[-1][0] == 1.0


def test_can_place_verdicts_match_reference():
    """``_can_place`` and the pool signature: a snapshot-carrying
    sequence moves only between replicas of one page geometry (page size,
    table width, leaf paths, dtypes and row shapes: a page's rows are
    part of its leaf shape), a fresh one wherever its tokens fit; the
    verdicts equal the reference's."""
    variants = {
        "f32": ({}, {}, {}),
        "f32 again": ({}, {}, {}),
        "int8": ({}, {"quantize_kv": True}, {}),
        "bf16": ({"dtype": "bfloat16"}, {}, {}),
        "page 4": ({}, {}, {"page_size": 4, "table_width": 16}),
        "short": ({}, {}, {"table_width": 2}),
    }

    def engines(side_of):
        out = {}
        for name, (over, paged, geo) in variants.items():
            side = side_of(over)
            g = dict(max_batch=2, prefill_batch=2, prefill_chunk=8,
                     page_size=8, num_pages=17, table_width=8)
            g.update(geo)
            out[name] = side, side.engine(
                sched=side.SchedConfig(**g),
                paged=side.PagedConfig(**paged))
        return out

    def verdicts(side_of):
        engs = engines(side_of)
        side, e0 = engs["f32"]
        router = side.Router([e0])
        out = {}
        for snap_pages in (None, 3, 5):
            for length in (10, 30):
                seq = e0.sched.submit(side.Request(
                    uid=len(out), prompt=np.ones(length, np.int32),
                    max_new=4))
                e0.sched.waiting.remove(seq)
                if snap_pages is not None:
                    seq.snapshot = object()
                    seq.snapshot_pages = list(range(1, snap_pages + 1))
                for name, (_, dst) in engs.items():
                    out[(snap_pages, length, name)] = \
                        router._can_place(e0, dst, seq)
        sigs = {name: router._pool_signature(e) == router._pool_signature(e0)
                for name, (_, e) in engs.items()}
        return out, sigs

    got, sigs = verdicts(lambda over: _Side(True, **over))
    want, jsigs = verdicts(lambda over: _Side(False, **over))
    assert got == want and sigs == jsigs
    assert sigs == {"f32": True, "f32 again": True, "int8": False,
                    "bf16": False, "page 4": False, "short": True}
    assert got[(3, 10, "f32 again")] and not got[(3, 10, "int8")]
    assert not got[(3, 10, "bf16")] and not got[(3, 10, "page 4")]
    assert not got[(3, 10, "short")] and got[(None, 10, "int8")]
    assert not got[(None, 30, "short")]


def test_pool_signature_refuses_other_memory_rows():
    """Enc-dec replicas whose pools agree in every paged and slot leaf
    but whose memory rows differ (enc_len 16 against 8): the signatures
    differ only in the memory pool's row, so a snapshot-carrying
    sequence (its snapshot holds the encoded memory) may not move, a
    fresh one may; the verdicts and signatures equal the reference's."""
    import dataclasses
    from repro.serving.mesh.router import Router as JRouter

    jbase = jregistry.reduced("seamless-m4t-large-v2", n_layers=2)
    jparams = jax.jit(jT.init, static_argnums=1)(jax.random.PRNGKey(0),
                                                 jbase)

    def verdicts(port):
        reg = registry if port else jregistry
        base = reg.reduced("seamless-m4t-large-v2", n_layers=2)
        if port:
            params = convert.params_from_jax(jax.tree.map(
                np.asarray, jparams), base, device="cpu")
            mk = lambda c: Engine(c, params, sched=SchedConfig(  # noqa
                max_batch=2, prefill_batch=2, prefill_chunk=8, page_size=8,
                num_pages=17, table_width=8), device="cpu")
            rt, req = Router, Request
        else:
            params = jparams
            mk = lambda c: jserving.Engine(  # noqa: E731
                c, params, sched=jserving.SchedConfig(
                    max_batch=2, prefill_batch=2, prefill_chunk=8,
                    page_size=8, num_pages=17, table_width=8))
            rt, req = JRouter, jserving.Request
        engs = {"same": mk(base), "short memory": mk(
            dataclasses.replace(base, enc_len=8))}
        e0 = mk(base)
        router = rt([e0])
        sigs = {k: router._pool_signature(e) == router._pool_signature(e0)
                for k, e in engs.items()}
        out = {}
        for snap in (False, True):
            seq = e0.sched.submit(req(uid=len(out), prompt=np.ones(
                10, np.int32), max_new=4, enc_emb=np.zeros(
                    (base.enc_len, 160), np.float32)))
            e0.sched.waiting.remove(seq)
            if snap:
                seq.snapshot = object()
                seq.snapshot_pages = [1, 2]
            for k, e in engs.items():
                out[(snap, k)] = router._can_place(e0, e, seq)
        return sigs, out

    sigs, got = verdicts(True)
    assert (sigs, got) == verdicts(False)
    assert sigs == {"same": True, "short memory": False}
    assert got == {(False, "same"): True, (False, "short memory"): True,
                   (True, "same"): True, (True, "short memory"): False}


def _preempt_then_migrate(side):
    """Replica 0's pool is tight enough to preempt mid-decode; replica 1
    (one geometry, more pages) adopts the evicted, snapshot-carrying
    sequences through migration and restores them."""
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, side.cfg.vocab, 3).astype(np.int32)
               for _ in range(4)]
    geo = dict(max_batch=4, prefill_batch=2, prefill_chunk=4, page_size=4,
               table_width=4)

    def mk():
        return [side.Request(uid=i, prompt=p.copy(), max_new=10)
                for i, p in enumerate(prompts)]
    solo = side.engine(sched=side.SchedConfig(num_pages=33, **geo))
    want = mk()
    for r in want:
        solo.submit(r)
    solo.run()
    e0 = side.engine(sched=side.SchedConfig(num_pages=9, **geo))
    e1 = side.engine(sched=side.SchedConfig(num_pages=33, **geo))
    router = side.Router([e0, e1], side.RouterConfig(migrate=True))
    reqs = mk()
    for r in reqs:
        e0.submit(r)
        router.home[r.uid] = 0
    router.run()
    restored = [ev["uid"] for ev in e1.metrics.events
                if ev["event"] == "restored"]
    return (_tokens(want), _tokens(reqs), e0.stats["preemptions"],
            router.stats["migrations"], restored, (e0, e1))


def test_preempted_sequence_migrates_with_its_snapshot():
    port, ref = _both()
    want, got, pre, migrations, restored, engines = \
        _preempt_then_migrate(port)
    assert pre > 0 and migrations > 0
    assert restored, "no snapshot-carrying sequence was adopted"
    assert got == want
    assert (want, got, pre, migrations, restored) == \
        _preempt_then_migrate(ref)[:5]
    for eng in engines:
        _assert_no_leaks(eng)
