"""The port's fault-tolerant serving (``serving/ft.py``, ``serving/chaos.py``,
``serving/mesh/router.py`` with ``ft``) against the reference's on the CPU.

The chaos matrix of ``tests/test_ft_serving.py``: reduced qwen3-4b (2
layers, f32) with full-KV pages, int8 pages and SRF state, reduced
hymba-1.5b (the hybrid cell: kv pages and ssd slots, so the router's
headroom and the oom fault's hostages span both domains) and reduced
seamless-m4t-large-v2 (the enc-dec cell: kv pages and a memory slot a
request, each request with its own encoder features, which a rescue
re-encodes on the surviving replica), replica 1 killed at its 4th step by each fault kind
(``raise``, ``hang``, ``reject``, ``oom``). The params are the
reference's, carried over with ``convert.params_from_jax``. In every
cell the port's greedy tokens equal the reference's undisturbed single
engine's, and its router counters equal the reference router's on the
same scenario; every uid is done exactly once, the scheduler invariants
hold after every round, and after ``heal()`` and ``revive(1)`` two more
requests are served with equal tokens and no page or slot leaks. The
watchdog, the chaos plans and the replay arithmetic are held to the
reference's on the same inputs.
"""
import itertools
import re

import jax
import numpy as np
import pytest
import torch

from repro import serving as jserving
from repro.configs import registry as jregistry
from repro.models import transformer as jT
from repro.obs import MetricsRegistry as JMetricsRegistry
from repro.serving import chaos as jchaos
from repro.serving import ft as jft
from repro_torch import convert
from repro_torch.configs import registry
from repro_torch.launch import serve
from repro_torch.models import frontends
from repro_torch.obs import MetricsRegistry
from repro_torch.serving import (Engine, FTConfig, PagedConfig,
                                 ReplicaWatchdog, Request, Router,
                                 RouterConfig, SchedConfig, Scheduler,
                                 plan_for)
from repro_torch.serving import ft as ft_lib
from repro_torch.serving.chaos import ChaosEngine, ChaosError, ChaosPlan

# one intra-op thread: the suite's pytest-xdist workers share the
# cores, and oversubscribed OpenMP pools spin against each other
torch.set_num_threads(1)

KINDS = ["raise", "hang", "reject", "oom"]
# cell -> (arch, config overrides, int8 pages); "hybrid" and "encdec"
# are the reference matrix's hymba-1.5b and seamless-m4t-large-v2 cells
# (plans with pages and slots)
CELLS = {"full KV": ("qwen3-4b", {}, False),
         "int8 pages": ("qwen3-4b", {}, True),
         "SRF": ("qwen3-4b", {"attn_impl": "srf"}, False),
         "hybrid": ("hymba-1.5b", {}, False),
         "encdec": ("seamless-m4t-large-v2", {}, False)}
N_REQ = 8
MAX_NEW = 10
COUNTERS = ("quarantined", "rescued", "replayed", "failed", "submitted")

_cache = {}
_ref_steps = {}


def _share_step(eng):
    """Reference engines of one (config, page layout) share the first
    one's jitted step (``make_paged_step(cfg, paged=...)``) and encode
    step: the reference wraps each in a new ``jax.jit`` per engine, so
    each would compile them anew."""
    eng._step = _ref_steps.setdefault((eng.cfg, eng.paged), eng._step)
    eng._encode = _ref_steps.setdefault(eng.cfg, eng._encode)
    return eng


class _Pkg:
    """One package's serving names, so one scenario drives either."""

    def __init__(self, torch_side):
        if torch_side:
            self.Engine, self.Request, self.Router = Engine, Request, Router
            self.RouterConfig, self.FTConfig = RouterConfig, FTConfig
            self.PagedConfig, self.Registry = PagedConfig, MetricsRegistry
            self.ChaosEngine, self.ChaosPlan = ChaosEngine, ChaosPlan
            self.kw = {"device": "cpu"}
        else:
            self.Engine, self.Request = jserving.Engine, jserving.Request
            self.Router = jserving.Router
            self.RouterConfig = jserving.RouterConfig
            self.FTConfig = jserving.FTConfig
            self.PagedConfig = jserving.PagedConfig
            self.Registry = JMetricsRegistry
            self.ChaosEngine = jchaos.ChaosEngine
            self.ChaosPlan = jchaos.ChaosPlan
            self.kw = {}


PORT, REF = _Pkg(True), _Pkg(False)


def _setup(cell):
    """Both packages' configs and params for ``cell``, the request
    blueprints (tests/test_ft_serving.py's recipe) and the reference's
    undisturbed single-engine tokens (cached across cells)."""
    if cell in _cache:
        return _cache[cell]
    arch, over, quant = CELLS[cell]
    jcfg = jregistry.reduced(arch, n_layers=2, **over)
    cfg = registry.reduced(arch, n_layers=2, **over)
    jparams = jT.init(jax.random.PRNGKey(0), jcfg)
    params = convert.params_from_jax(jax.tree.map(np.asarray, jparams), cfg,
                                     device="cpu")
    rng = np.random.default_rng(0)
    blue, enc = [], []
    for _ in range(N_REQ):      # the reference recipe: features, prompt
        enc.append(frontends.synthetic_audio_features(rng, cfg)
                   if cfg.is_encdec else None)
        blue.append(rng.integers(1, cfg.vocab, int(rng.integers(4, 20)))
                    .astype(np.int32))
    ref = _requests(REF, blue, enc)
    eng = _share_step(REF.Engine(jcfg, jparams, batch_slots=2, max_len=64,
                                 seed=0,
                                 paged=REF.PagedConfig(quantize_kv=quant)))
    for r in ref:
        eng.submit(r)
    eng.run()
    want = {r.uid: list(r.out_tokens) for r in ref}
    assert all(len(t) == MAX_NEW for t in want.values())
    _cache[cell] = {"jcfg": jcfg, "jparams": jparams, "cfg": cfg,
                    "params": params, "blue": blue, "enc": enc,
                    "want": want,
                    "quant": quant}
    return _cache[cell]


def _requests(pkg, blue, enc=None, **kw):
    # fresh Request objects per run; prompts copied because a replay
    # folds emitted tokens into req.prompt in place; ``enc``: each
    # request's encoder features (enc-dec)
    return [pkg.Request(uid=i, prompt=p.copy(), max_new=MAX_NEW,
                        enc_emb=None if enc is None else enc[i], **kw)
            for i, p in enumerate(blue)]


def _inner(e):
    return getattr(e, "_eng", e)


def _check_allocators(engines, allow_foreign=False):
    """tests/test_ft_serving.py's per-replica invariants; ``allow_foreign``
    tolerates the oom fault's hostage allocations."""
    for e in engines:
        sched = _inner(e).sched
        a = sched.alloc
        assert a.free_pages + a.used_pages == a.num_pages - 1
        owned = [p for s in sched.running for p in s.table.pages]
        assert len(owned) == len(set(owned))
        assert 0 not in owned
        if allow_foreign:
            assert set(owned) <= a._allocated
        else:
            assert set(owned) == a._allocated
        for s in sched.waiting:
            assert not s.table.pages and s.slot is None
        if sched.slot_alloc is not None:
            sa = sched.slot_alloc
            assert sa.free_pages + sa.used_pages == sa.num_pages - 1
            slots = [s.slot for s in sched.running if s.slot is not None]
            assert len(slots) == len(set(slots))
            assert 0 not in slots
            if allow_foreign:
                assert set(slots) <= sa._allocated
            else:
                assert set(slots) == sa._allocated


def _check_conservation(reg, engines):
    """Requests are conserved across all replicas: a rescue moves them
    between schedulers, never makes or loses one."""
    running = sum(len(_inner(e).sched.running) for e in engines)
    waiting = sum(len(_inner(e).sched.waiting) for e in engines)
    v = reg.value_sum
    assert v("sched_submitted_total") + v("sched_adopted_total") == \
        v("sched_finished_total") + v("sched_released_total") + \
        running + waiting


def _steady(engines):
    """Give each engine a step-time clock that advances 5 ms a read, so
    every step records 5 ms (plus the hang fault's stall): the watchdog's
    slow detector compares wall step times across replicas, and on a CPU
    a replica whose steps turned into no-ops (oom, reject) would race
    its busy peer's slow flag against its own stuck count."""
    for e in engines:
        ticks = itertools.count()
        e.clock = lambda ticks=ticks: 0.005 * next(ticks)
    return engines


def _chaos_router(pkg, s, kind, seeds=(0, 1), **req_kw):
    """tests/test_ft_serving.py's scenario: 2 replicas of 2 slots, replica
    1 faulted at its 4th step, no migration, FTConfig(grace_steps=2,
    stuck_rounds=3); returns (router, engines, registry, requests,
    submit's return values)."""
    port = pkg is PORT
    cfg, params = (s["cfg"], s["params"]) if port else (s["jcfg"],
                                                         s["jparams"])
    reg = pkg.Registry()
    engines = [pkg.Engine(cfg, params, batch_slots=2, max_len=64, seed=i,
                          metrics=reg,
                          paged=pkg.PagedConfig(quantize_kv=s["quant"]),
                          **pkg.kw) for i in seeds]
    if not port:
        engines = [_share_step(e) for e in engines]
    _steady(engines)
    engines[1] = pkg.ChaosEngine(engines[1], pkg.ChaosPlan(kind, at_step=4))
    router = pkg.Router(engines, cfg=pkg.RouterConfig(migrate=False),
                        metrics=reg,
                        ft=pkg.FTConfig(grace_steps=2, stuck_rounds=3))
    reqs = _requests(pkg, s["blue"], s["enc"], **req_kw)
    homes = [router.submit(r) for r in reqs]
    return router, engines, reg, reqs, homes


def _counters(reg):
    return {k: reg.value_sum(f"router_{k}_total") for k in COUNTERS}


_ref_runs = {}


def _reference_run(cell, kind, **req_kw):
    """The reference router's counters, homes and tokens on the scenario
    (cached)."""
    key = (cell, kind, tuple(sorted(req_kw.items())))
    if key not in _ref_runs:
        s = _setup(cell)
        seeds = (0, 0) if req_kw else (0, 1)
        router, _, reg, reqs, homes = _chaos_router(REF, s, kind, seeds,
                                                    **req_kw)
        router.run()
        _ref_runs[key] = {"counters": _counters(reg), "homes": homes,
                          "home": dict(router.home),
                          "tokens": {r.uid: list(r.out_tokens)
                                     for r in reqs}}
    return _ref_runs[key]


@pytest.mark.parametrize("cell", list(CELLS))
@pytest.mark.parametrize("kind", KINDS)
def test_chaos_matrix_matches_reference(cell, kind):
    s = _setup(cell)
    ref = _reference_run(cell, kind)
    router, engines, reg, reqs, homes = _chaos_router(PORT, s, kind)
    assert homes == ref["homes"]

    def on_step(rt):
        _check_allocators(rt.engines, allow_foreign=(kind == "oom"))
        _check_conservation(reg, rt.engines)

    router.run(on_step=on_step)

    assert all(r.done for r in reqs)
    assert all(r.finish_reason in ("eos", "length") for r in reqs)
    dones = {}
    for ev in reg.events:
        if ev.get("event") == "done":
            dones[ev["uid"]] = dones.get(ev["uid"], 0) + 1
    assert dones == {i: 1 for i in range(N_REQ)}
    got = {r.uid: list(r.out_tokens) for r in reqs}
    assert got == s["want"] == ref["tokens"]
    assert _counters(reg) == ref["counters"]
    assert router.home == ref["home"]
    assert reg.value_sum("router_quarantined_total") == 1
    assert router.dead == {1}
    assert reg.value_sum("router_rescued_total") + \
        reg.value_sum("router_replayed_total") >= 1
    assert reg.value_sum("router_failed_total") == 0

    engines[1].heal()
    assert router.revive(1)
    assert router.dead == set()
    assert reg.value_sum("router_revived_total") == 1
    extra = [Request(uid=100 + i, prompt=s["blue"][i].copy(),
                     max_new=MAX_NEW, enc_emb=s["enc"][i]) for i in range(2)]
    for r in extra:
        router.submit(r)
    router.run(on_step=lambda rt: _check_allocators(rt.engines))
    assert all(r.done and list(r.out_tokens) == s["want"][i]
               for i, r in enumerate(extra))
    for e in engines:
        sched = _inner(e).sched
        assert sched.alloc.used_pages == 0
        if sched.slot_alloc is not None:
            assert sched.slot_alloc.used_pages == 0
    _check_conservation(reg, engines)


def test_chaos_sampled_decode_bitmatch():
    """Sampled decode survives a mid-decode kill bit for bit: the noise is
    keyed by (engine seed, uid, token index), so with both replicas at
    seed 0 the rescue replica draws what the killed one would have, and
    the streams equal the reference's undisturbed sampled engine's."""
    s = _setup("full KV")
    samp = dict(temperature=0.9, top_k=50, top_p=0.95)
    ref = _requests(REF, s["blue"], **samp)
    eng = _share_step(REF.Engine(s["jcfg"], s["jparams"], batch_slots=2,
                                 max_len=64, seed=0))
    for r in ref:
        eng.submit(r)
    eng.run()
    want = {r.uid: list(r.out_tokens) for r in ref}
    assert any(want[i] != s["want"][i] for i in want), \
        "sampling gave the greedy streams; the cell is vacuous"

    router, _, reg, reqs, _ = _chaos_router(PORT, s, "raise", (0, 0),
                                            **samp)
    router.run()
    assert all(r.done and r.finish_reason in ("eos", "length")
               for r in reqs)
    assert {r.uid: list(r.out_tokens) for r in reqs} == want
    assert _counters(reg) == _reference_run("full KV", "raise",
                                            **samp)["counters"]
    assert reg.value_sum("router_quarantined_total") == 1
    assert reg.value_sum("router_rescued_total") + \
        reg.value_sum("router_replayed_total") >= 1
    assert reg.value_sum("router_failed_total") == 0


# ---------------------------------------------------------------------------
# the chaos harness
# ---------------------------------------------------------------------------

def test_chaos_plan_from_seed_matches_reference():
    for seed in range(32):
        a, b = ChaosPlan.from_seed(seed), jchaos.ChaosPlan.from_seed(seed)
        assert (a.kind, a.at_step) == (b.kind, b.at_step)
    assert {ChaosPlan.from_seed(s).kind for s in range(32)} == set(KINDS)
    with pytest.raises(ValueError):
        ChaosPlan("segfault")


def test_chaos_raise_without_ft_propagates():
    """Without ``ft`` the router does not swallow a replica's exception."""
    s = _setup("full KV")
    engines = [Engine(s["cfg"], s["params"], batch_slots=2, max_len=64,
                      seed=i, device="cpu") for i in range(2)]
    engines[1] = ChaosEngine(engines[1], ChaosPlan("raise", at_step=1))
    router = Router(engines)
    for r in _requests(PORT, s["blue"]):
        router.submit(r)
    with pytest.raises(ChaosError):
        router.run()


def test_chaos_engine_run_and_heal():
    """``ChaosEngine.run`` steps through the injecting ``step``: an oom
    fault stalls it; after ``heal()`` the hostage pages are back and the
    queue drains with the undisturbed tokens."""
    s = _setup("full KV")
    eng = ChaosEngine(Engine(s["cfg"], s["params"], batch_slots=2,
                             max_len=64, seed=0, device="cpu"),
                      ChaosPlan("oom", at_step=2))
    reqs = _requests(PORT, s["blue"])
    for r in reqs:
        eng.submit(r)
    with pytest.raises(RuntimeError, match="stalled"):
        eng.run()
    assert eng.tripped and eng.free_pages == 0
    assert eng.stats["preemptions"] > 0
    eng.heal()
    eng.run()
    assert all(r.done for r in reqs)
    assert {r.uid: list(r.out_tokens) for r in reqs} == s["want"]
    assert eng.sched.alloc.used_pages == 0


# ---------------------------------------------------------------------------
# the watchdog: synthetic observations, no engines
# ---------------------------------------------------------------------------

def _both(n, **kw):
    return ReplicaWatchdog(n, FTConfig(**kw)), \
        jft.ReplicaWatchdog(n, jft.FTConfig(**kw))


def _feed(pair, obs):
    """Feed ``obs`` ((idx, dt, progressed, has_work) or ("dead"|"revive",
    idx)) to both watchdogs; their verdicts and state must agree."""
    ours, theirs = pair
    verdicts = []
    for o in obs:
        if o[0] in ("dead", "revive"):
            for wd in pair:
                (wd.mark_dead if o[0] == "dead" else wd.revive)(o[1])
            continue
        v = ours.observe(*o)
        assert v == theirs.observe(*o)
        verdicts.append(v)
        assert (ours.ema, ours.flags, ours.stuck, ours.dead) == \
            (theirs.ema, theirs.flags, theirs.stuck, theirs.dead)
    return verdicts


def test_watchdog_flags_slow_replica_vs_peer_median():
    obs = [(i, 0.5 if i == 2 else 0.01, True, True)
           for _ in range(6) for i in range(3)]
    v = _feed(_both(3, ema=0.5, threshold=2.0, grace_steps=2), obs)
    assert v[-1] is not None and "slow" in v[-1]
    # two replicas: the slow one is still found (peer median, not the
    # global median, whose upper value is the slow replica itself)
    obs = [(i, 0.5 if i else 0.01, True, True)
           for _ in range(6) for i in range(2)]
    v = _feed(_both(2, ema=0.5, threshold=2.0, grace_steps=2), obs)
    assert v[-1] is not None and "slow" in v[-1]


def test_watchdog_stuck_and_reset():
    v = _feed(_both(2, stuck_rounds=3), [(0, None, False, True)] * 3)
    assert v[:2] == [None, None] and "stuck" in v[2]
    # progress resets the streak; idle (no work) never counts as stuck
    v = _feed(_both(2, stuck_rounds=2),
              [(0, None, False, True), (0, None, True, True),
               (0, None, False, True), (1, None, False, False),
               (1, None, False, False)])
    assert v[2:] == [None, None, None]


def test_watchdog_seeded_sequence_matches_reference():
    """400 random observations over 3 replicas, with deaths and revivals:
    every verdict and the EMA, flag and stuck state equal the
    reference's."""
    rng = np.random.default_rng(7)
    obs = []
    for _ in range(400):
        u = rng.random()
        if u < 0.02:
            obs.append(("dead", int(rng.integers(3))))
        elif u < 0.05:
            obs.append(("revive", int(rng.integers(3))))
        else:
            i = int(rng.integers(3))
            dt = None if rng.random() < 0.2 else \
                float(rng.lognormal(-4 + 2 * (i == 1), 1.0))
            obs.append((i, dt, bool(rng.random() < 0.8),
                        bool(rng.random() < 0.9)))
    v = _feed(_both(3, ema=0.6, threshold=3.0, grace_steps=2,
                    stuck_rounds=3), obs)
    assert any(x and "slow" in x for x in v)
    assert any(x and "stuck" in x for x in v)


def test_watchdog_reads_step_times_from_the_registry():
    """``poll_step_time`` reads the engine's ``engine_step_seconds``
    through the (count, sum) watermark: the mean of what landed since
    the last poll, ``None`` when nothing did."""
    s = _setup("full KV")
    eng = Engine(s["cfg"], s["params"], batch_slots=2, max_len=64,
                 device="cpu")
    ticks = iter(np.arange(0.0, 100.0, 0.25))
    eng.clock = lambda: float(next(ticks))       # 0.25 s a step
    wd = ReplicaWatchdog(1, FTConfig())
    assert wd.poll_step_time(0, eng) is None
    eng.submit(Request(uid=0, prompt=s["blue"][0].copy(), max_new=3))
    eng.step()
    eng.step()
    assert wd.poll_step_time(0, eng) == 0.25
    assert wd.poll_step_time(0, eng) is None


# ---------------------------------------------------------------------------
# replay arithmetic, deadlines' neighbours, degradation
# ---------------------------------------------------------------------------

def test_fold_emitted_prefix_exactly_once_arithmetic():
    req = Request(uid=0, prompt=np.array([1, 2, 3], np.int32), max_new=8)
    req.out_tokens.extend([7, 8, 9])
    jreq = jserving.Request(uid=0, prompt=np.array([1, 2, 3], np.int32),
                            max_new=8)
    jreq.out_tokens.extend([7, 8, 9])
    hwm = ft_lib.fold_emitted_prefix(req)
    assert hwm == jft.fold_emitted_prefix(jreq) == 3
    assert list(req.prompt) == list(jreq.prompt) == [1, 2, 3, 7, 8, 9]
    assert req.prompt.dtype == jreq.prompt.dtype
    assert req.out_tokens == [7, 8, 9]      # never truncated
    assert len(req.prompt) + (req.max_new - hwm) == 3 + req.max_new
    empty = Request(uid=1, prompt=np.array([4], np.int32))
    assert ft_lib.fold_emitted_prefix(empty) == 0
    assert list(empty.prompt) == [4]


def test_snapshot_is_current_and_probe():
    s = _setup("full KV")
    sched = Scheduler(SchedConfig(page_size=4, num_pages=13, table_width=4),
                      plan_for(s["cfg"]))
    seq = sched.submit(Request(uid=0, prompt=np.ones(3, np.int32),
                               max_new=2))
    assert not ft_lib.snapshot_is_current(seq)
    seq.snapshot = object()
    assert ft_lib.snapshot_is_current(seq)
    probe, jprobe = ft_lib.make_probe(s["cfg"], uid=-2, max_new=3), \
        jft.make_probe(s["jcfg"], uid=-2, max_new=3)
    assert (probe.uid, list(probe.prompt), probe.max_new) == \
        (jprobe.uid, list(jprobe.prompt), jprobe.max_new)
    encdec = registry.reduced("seamless-m4t-large-v2")
    jencdec = jregistry.reduced("seamless-m4t-large-v2")
    probe, jprobe = ft_lib.make_probe(encdec), jft.make_probe(jencdec)
    assert list(probe.prompt) == list(jprobe.prompt)
    assert probe.enc_emb.dtype == np.float32 and \
        np.array_equal(probe.enc_emb, jprobe.enc_emb)
    assert ft_lib.make_probe(s["cfg"]).enc_emb is None


def test_fits_is_remaining_aware_for_replays():
    s = _setup("full KV")
    sched = Scheduler(SchedConfig(page_size=4, num_pages=13, table_width=4),
                      plan_for(s["cfg"]))         # capacity 16 tokens
    req = Request(uid=0, prompt=np.ones(6, np.int32), max_new=8)
    assert sched.fits(req)                        # 6 + 8 <= 16
    req.out_tokens.extend([1, 2, 3, 4])
    ft_lib.fold_emitted_prefix(req)               # prompt now 10 tokens
    assert sched.fits(req)                        # 10 + (8 - 4) <= 16


def _flood(pkg, s):
    """tests/test_ft_serving.py's degradation scenario: max_len 32 pools
    of 16 pages of 8 on 2 replicas, flooded with 24 requests; returns
    (router, registry, flood, the round degraded was entered, the shed
    request)."""
    port = pkg is PORT
    cfg, params = (s["cfg"], s["params"]) if port else (s["jcfg"],
                                                         s["jparams"])
    reg = pkg.Registry()
    engines = [pkg.Engine(cfg, params, batch_slots=2, max_len=32, seed=i,
                          metrics=reg, **pkg.kw) for i in range(2)]
    if not port:
        engines = [_share_step(e) for e in engines]
    engines = _steady(engines)
    router = pkg.Router(engines, metrics=reg,
                        ft=pkg.FTConfig(degraded_rounds=2))
    flood = [pkg.Request(uid=100 + i, prompt=s["blue"][i % N_REQ][:12].copy(),
                         max_new=MAX_NEW) for i in range(24)]
    for r in flood:
        router.submit(r)
    for k in range(60):
        router.step()
        if router.state == "degraded":
            extra = pkg.Request(uid=999, prompt=s["blue"][0][:12].copy(),
                                max_new=MAX_NEW)
            assert router.submit(extra) == -1     # reject-new, not evict
            return router, reg, flood, k, extra
    raise AssertionError("router never entered the degraded state")


def test_degraded_sheds_new_requests_then_recovers():
    s = _setup("full KV")
    router, reg, flood, k, shed = _flood(PORT, s)
    jrouter, _, jflood, jk, _ = _flood(REF, s)
    assert k == jk
    assert shed.done and shed.finish_reason == "shed"
    assert not shed.out_tokens
    assert reg.value_sum("router_shed_total") == 1
    assert reg.value_sum("router_tenant_shed_total") == 1
    assert reg.value_sum("router_degraded") == 1
    done = router.run()
    assert len(done) == len(flood)
    assert all(r.finish_reason in ("eos", "length") for r in flood)
    assert router.state == "ok"
    assert reg.value_sum("router_degraded") == 0
    # the flood's tokens equal the reference router's on the same flood
    jrouter.run()
    assert {r.uid: list(r.out_tokens) for r in flood} == \
        {r.uid: list(r.out_tokens) for r in jflood}


def test_router_counters_survive_replica0_quarantine():
    """The router's series live in its own registry: kill replica 0 and
    they keep counting; none of them lands in a replica's registry."""
    s = _setup("full KV")
    engines = _steady([Engine(s["cfg"], s["params"], batch_slots=2,
                              max_len=64, seed=i, device="cpu")
                       for i in range(2)])
    engines[0] = ChaosEngine(engines[0], ChaosPlan("raise", at_step=3))
    router = Router(engines, ft=FTConfig())
    assert router.metrics is not engines[1].metrics
    assert router.metrics is not _inner(engines[0]).metrics
    reqs = _requests(PORT, s["blue"])
    for r in reqs:
        router.submit(r)
    router.run()
    assert all(r.done for r in reqs)
    assert {r.uid: list(r.out_tokens) for r in reqs} == s["want"]
    assert router.metrics.value_sum("router_quarantined_total") == 1
    assert router.metrics.value_sum("router_submitted_total") == N_REQ
    snap = engines[1].metrics.snapshot()["counters"]
    assert "router_quarantined_total" not in snap


def test_replay_budget_exhausted_fails_the_request():
    """A request whose retries are spent is failed, not replayed: done,
    ``failed``, counted, and its tokens so far kept."""
    s = _setup("full KV")
    reg = MetricsRegistry()
    engines = _steady([Engine(s["cfg"], s["params"], batch_slots=2,
                              max_len=64, seed=i, metrics=reg, device="cpu")
                       for i in range(2)])
    engines[1] = ChaosEngine(engines[1], ChaosPlan("raise", at_step=4))
    router = Router(engines, cfg=RouterConfig(migrate=False), metrics=reg,
                    ft=FTConfig())
    reqs = [Request(uid=i, prompt=p.copy(), max_new=MAX_NEW, max_retries=0)
            for i, p in enumerate(s["blue"])]
    for r in reqs:
        router.submit(r)
    router.run()
    failed = [r for r in reqs if r.finish_reason == "failed"]
    assert failed and all(r.done and r.retries == 0 for r in failed)
    assert reg.value_sum("router_failed_total") == len(failed)
    assert reg.value_sum("router_replayed_total") == 0
    assert all(r.out_tokens == s["want"][r.uid][:len(r.out_tokens)]
               for r in failed)


# ---------------------------------------------------------------------------
# the serve CLI
# ---------------------------------------------------------------------------

def test_cli_replicas_ft_chaos(capsys, tmp_path):
    prom = tmp_path / "m.prom"
    trace = tmp_path / "t.json"
    argv = ["--arch", "qwen3-4b", "--reduced", "--device", "cpu",
            "--replicas", "2", "--ft", "--chaos", "raise@6:1",
            "--metrics-out", str(prom), "--trace-out", str(trace)]
    assert serve.main(argv) == 0
    out = capsys.readouterr().out
    assert "[chaos] replica 1: raise@6" in out
    assert "engine=router" in out and "requests=16 tokens=384" in out
    line = next(x for x in out.splitlines() if x.startswith("  router: "))
    assert "'quarantined': 1" in line and "'dead': [1]" in line
    text = prom.read_text()
    assert re.search(r"^router_quarantined_total 1(\.0)?$", text, re.M)
    # a counter never incremented exports no sample
    failed = re.search(r"^router_failed_total (\S+)$", text, re.M)
    assert failed is None or float(failed.group(1)) == 0
    assert "across 3 timelines" in out           # 2 replicas + the router


def test_cli_model_parallel_is_a_usage_error(capsys):
    """``--model-parallel`` builds its meshes from the visible cards, as
    the reference does from its devices: too few raise ``ValueError``
    before any weight is drawn; with ``--device cpu`` the positions are
    CPU ones and the sharded replicas serve."""
    need = 2 * 2
    if torch.cuda.device_count() >= need:
        pytest.skip("enough cards for 2 replicas x model=2")
    with pytest.raises(ValueError, match=f"need {need} devices"):
        serve.main(["--arch", "qwen3-4b", "--reduced", "--replicas", "2",
                    "--model-parallel", "2", "--requests", "2"])
    assert serve.main(["--arch", "qwen3-4b", "--reduced", "--device", "cpu",
                       "--model-parallel", "2", "--requests", "2",
                       "--max-new", "2"]) == 0
    out = capsys.readouterr().out
    assert "engine=router" in out and "'pool_bytes_per_device'" in out