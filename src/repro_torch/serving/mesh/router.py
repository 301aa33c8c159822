"""Request router over paged-serving engine replicas.

Port of ``repro.serving.mesh.router``. Each replica is one
:class:`~repro_torch.serving.engine.Engine`, plain or mesh-sharded
(``Engine(mesh=...)``, one mesh a replica: ``launch.mesh.make_serving_meshes``).
The router is host-side control plane, the scheduler/engine split one
level up: engines own device state, the router decides which engine a
request lives on.

Placement: free-page **pressure**. A request goes to the replica whose
pool has the most free pages per queued demand (each waiting request
discounts its page need from the replica's headroom), so short bursts
spread instead of piling onto replica 0. While draining, the router
also *migrates* waiting requests off saturated replicas: a sequence
still in a replica's admission queue holds no device pages (a fresh
request none; an evicted one only a host-side snapshot), so moving it
is a scheduler hand-off (``Scheduler.release_waiting`` / ``adopt``),
never a device copy.

Fault tolerance (``Router(ft=FTConfig())``, see ``serving/ft.py``): a
replica is **quarantined** when an exception escapes its ``step`` or
the :class:`~repro_torch.serving.ft.ReplicaWatchdog` flags it (slow by
the recorded ``engine_step_seconds``, or stuck with work queued). Its
sequences are **rescued**: waiting ones re-homed through the migration
hand-off, running ones (device state lost) **replayed** on a survivor
with their emitted tokens folded in as a forced prefix; placement
shrinks to the survivors. ``revive()`` rejoins a repaired replica after
a probe request completes. Under sustained pool exhaustion the router
enters the ``degraded`` state and sheds NEW requests (reject-new before
evict-running) instead of thrashing the evict/restore path. Every
transition is a counter and an event:
``router_{quarantined,rescued,replayed,failed,shed,revived}_total`` and
the gauges ``router_degraded`` and ``router_dead_replicas``.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Set

from repro_torch import tree as tree_lib
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import spans as obs_spans
from repro_torch.obs import trace as obs_trace

from .. import ft as ft_lib
from .. import paged_cache
from ..engine import Engine, Request
from ..scheduler import Sequence, tenant_of


@dataclass(frozen=True)
class RouterConfig:
    migrate: bool = True
    # a replica is "saturated" when its discounted headroom is below this
    # fraction of the pool while another replica has at least twice the
    # absolute headroom; the hysteresis keeps requests from ping-ponging
    saturation: float = 0.125
    migrate_per_round: int = 4       # bound control-plane work per step


class Router:
    """Spread requests across engine replicas and migrate under pressure;
    with ``ft``, also detect dead replicas and rescue their work."""

    def __init__(self, engines: List[Engine],
                 cfg: Optional[RouterConfig] = None,
                 metrics: Optional[obs_metrics.MetricsRegistry] = None,
                 ft: Optional[ft_lib.FTConfig] = None, spans=None):
        if not engines:
            raise ValueError("router needs >= 1 engine replica")
        fam = engines[0].plan.name
        if any(e.plan.name != fam for e in engines):
            raise ValueError("router replicas must serve one pool plan")
        self.engines = list(engines)
        self.cfg = cfg or RouterConfig()
        self.ft = ft
        self.home: Dict[int, int] = {}       # request uid -> replica index
        self.dead: Set[int] = set()          # quarantined replica indices
        self.state = "ok"                    # ok | degraded
        self._exhausted_rounds = 0
        # the router's series go to a registry of their own unless one is
        # given: in engines[0]'s registry every router counter would be
        # orphaned once replica 0 is quarantined. The serve CLI passes
        # its one shared registry, so one scrape covers the deployment.
        self.metrics = metrics if metrics is not None \
            else obs_metrics.MetricsRegistry()
        self.spans = spans if spans is not None else obs_spans.NOOP
        self.watchdog = (ft_lib.ReplicaWatchdog(len(engines), ft,
                                                spans=self.spans)
                         if ft is not None else None)
        self._c_submitted = self.metrics.counter(
            "router_submitted_total", "requests routed to a replica")
        self._c_migrations = self.metrics.counter(
            "router_migrations_total", "waiting sequences moved between "
            "replicas under pressure")
        self._c_steps = self.metrics.counter(
            "router_steps_total", "router drive rounds")
        self._c_quarantined = self.metrics.counter(
            "router_quarantined_total", "replicas marked dead")
        self._c_rescued = self.metrics.counter(
            "router_rescued_total", "waiting sequences re-homed off a "
            "dead replica (snapshot/prefill progress kept)")
        self._c_replayed = self.metrics.counter(
            "router_replayed_total", "requests re-submitted with their "
            "emitted tokens as a forced prefix (device state lost)")
        self._c_failed = self.metrics.counter(
            "router_failed_total", "requests terminally failed (retry "
            "budget exhausted or no live replica fits)")
        self._c_shed = self.metrics.counter(
            "router_shed_total", "new requests rejected in degraded state")
        self._c_revived = self.metrics.counter(
            "router_revived_total", "quarantined replicas rejoined after "
            "a successful probe")
        self._c_tenant_shed = self.metrics.counter(
            "router_tenant_shed_total",
            "new requests rejected in degraded state, by tenant "
            "namespace", ("tenant",))
        self._g_headroom = self.metrics.gauge(
            "router_headroom", "discounted free capacity per replica "
            "(pages/slots minus queued demand)", ("replica",))
        self._g_degraded = self.metrics.gauge(
            "router_degraded", "1 while shedding new load (sustained "
            "pool exhaustion)")
        self._g_dead = self.metrics.gauge(
            "router_dead_replicas", "replicas currently quarantined")
        self.stats = obs_metrics.StatsView({
            "submitted": self._c_submitted.value,
            "migrations": self._c_migrations.value,
            "steps": self._c_steps.value,
            "quarantined": self._c_quarantined.value,
            "rescued": self._c_rescued.value,
            "replayed": self._c_replayed.value,
            "shed": self._c_shed.value,
            "revived": self._c_revived.value,
        })

    # -- pressure ------------------------------------------------------------

    def _live(self) -> List[int]:
        return [i for i in range(len(self.engines)) if i not in self.dead]

    def _demand_pages(self, eng: Engine, seq: Sequence) -> int:
        """Paged-domain pages the sequence needs at admission on this
        replica (a slot-only plan counts its one slot instead, so that
        pressure still reflects real demand)."""
        if not eng.plan.has_paged:
            return 1
        if seq.snapshot is not None:
            return max(len(seq.snapshot_pages), 1)
        return eng.sched._pages_for(max(seq.prompt_len, 1))

    def _demand_req(self, eng: Engine, req: Request) -> int:
        """Admission demand of a request not yet submitted."""
        if not eng.plan.has_paged:
            return 1
        return eng.sched._pages_for(max(len(req.prompt), 1))

    def _headroom(self, eng: Engine) -> int:
        """Free capacity minus the queued demand already bound for
        ``eng``: the minimum over the domains the plan allocates from
        (pages for KV, slots for constant state)."""
        hs = []
        if eng.plan.has_paged:
            queued = sum(self._demand_pages(eng, s)
                         for s in eng.sched.waiting)
            hs.append(eng.free_pages - queued)
        if eng.sched.slot_alloc is not None:
            hs.append(eng.free_slots - len(eng.sched.waiting))
        return min(hs)

    def pressure(self) -> List[int]:
        return [self._headroom(e) for e in self.engines]

    # -- submission ----------------------------------------------------------

    def _affinity_pages(self, eng: Engine, req: Request) -> int:
        """Prefix-cache affinity bonus in headroom units: the pages of the
        prompt this replica could serve from its cache (0 without a
        cache). A hit saves exactly that many page allocations and their
        prefill, so it is priced in the currency of free capacity."""
        peek = getattr(eng, "prefix_peek", None)
        if peek is None:
            return 0
        return peek(req) // max(eng.sched_cfg.page_size, 1)

    def submit(self, req: Request) -> int:
        """Route to the live replica with the most discounted headroom
        (credited with prefix-cache affinity) that can hold the request
        at all; returns the replica's index, or -1 when the request was
        shed in the degraded state."""
        stok = self.spans.begin("router_score", uid=req.uid)
        try:
            hr = {i: self._headroom(self.engines[i])
                  + self._affinity_pages(self.engines[i], req)
                  for i in self._live()}
            fitting = [i for i in sorted(hr, key=lambda i: -hr[i])
                       if self.engines[i].sched.fits(req)]
            if not fitting:
                raise ValueError(
                    f"request uid={req.uid} fits no replica "
                    f"(prompt={len(req.prompt)} + max_new={req.max_new})")
            best = fitting[0]
            stok.args["replica"] = best
            if (self.ft is not None and self.state == "degraded"
                    and hr[best] < self._demand_req(self.engines[best],
                                                    req)):
                # the degradation ladder's first rung: rejecting a NEW
                # request is cheaper than queueing it into an exhausted
                # pool, where it could only run by evicting running work
                stok.args["replica"] = -1
                return self._shed(req)
            eng = self.engines[best]
            eng.submit(req)
            self.home[req.uid] = best
            self._c_submitted.inc()
            self.metrics.event("routed", uid=req.uid, replica=best)
            return best
        finally:
            self.spans.end(stok)

    def _shed(self, req: Request) -> int:
        req.done = True
        req.finish_reason = "shed"
        now = time.perf_counter()
        req.t_submit = req.t_done = now
        if req.trace is None:
            req.trace = obs_trace.Trace(uid=req.uid)
        req.trace.stamp("queued", now)
        req.trace.stamp("done", now)
        self._c_shed.inc()
        self._c_tenant_shed.labels(tenant=tenant_of(req)).inc()
        self.spans.instant("shed", uid=req.uid, tenant=tenant_of(req))
        self.metrics.event("shed", uid=req.uid)
        return -1

    # -- migration -----------------------------------------------------------

    @staticmethod
    def _capacity(eng: Engine) -> int:
        """Units behind ``_headroom`` for the saturation threshold: the
        smallest domain the plan allocates from, as ``_headroom`` takes
        the minimum over domains."""
        caps = []
        if eng.plan.has_paged:
            caps.append(eng.usable_pages)
        if eng.sched.slot_alloc is not None:
            caps.append(eng.usable_slots)
        return min(caps)

    @staticmethod
    def _pool_signature(eng: Engine):
        """Per domain and segment, the sorted (leaf path, dtype, row
        shape) of every pool leaf, in GLOBAL shapes: all that a
        snapshot's scatter must agree on except the pools' page and slot
        counts. Leaves are (layers, pages or slots, ...), so the row
        shape drops axis 1. A snapshot holds global rows, so sharded and
        unsharded replicas of one geometry take each other's. An enc-dec
        engine adds its memory pool's (dtype, row shape): the snapshot
        carries the request's encoded memory."""
        def seg_sig(seg):
            if seg is None:
                return None
            return tuple(sorted(
                (path, str(a.dtype), tuple(a.shape[:1] + a.shape[2:]))
                for path, a in tree_lib.leaves_with_path(seg)))
        pools = paged_cache.global_view(eng.pools)
        sig = tuple(tuple(seg_sig(s) for s in pools[dom])
                    for dom in ("paged", "slot"))
        mem = pools.get("memory")
        if mem is not None:
            sig += ((str(mem.dtype), tuple(mem.shape[1:])),)
        return sig

    def _can_place(self, src: Engine, dst: Engine, seq: Sequence) -> bool:
        """Whether ``dst`` can adopt ``seq``. A preemption snapshot
        scatters page rows verbatim, so the page geometry (page_size and
        the pools' leaf structure, dtype and row shape: int8 against
        bf16 pages, bf16 against f32 configs) must match exactly;
        replicas of other pool shapes serve together, but a sequence
        carrying a snapshot is pinned to like-shaped replicas. Every
        sequence must also fit the destination's token capacity."""
        dc = dst.sched_cfg
        if seq.snapshot is not None:
            if src.sched_cfg.page_size != dc.page_size:
                return False
            if len(seq.snapshot_pages) > dc.table_width:
                return False
            if self._pool_signature(src) != self._pool_signature(dst):
                return False
        return dst.sched.fits(seq.req)

    def migrate(self) -> int:
        """Move waiting sequences from saturated live replicas to roomy
        live ones. Returns how many moved this round."""
        live = self._live()
        if not self.cfg.migrate or len(live) < 2:
            return 0
        moved = 0
        for src_i in live:
            src = self.engines[src_i]
            if moved >= self.cfg.migrate_per_round:
                break
            src_hr = self._headroom(src)
            if src_hr >= self.cfg.saturation * self._capacity(src):
                continue
            # saturated: offload the tail of the waiting queue (the head
            # is closest to admission here; the tail pays the wait)
            for seq in sorted(src.sched.waiting, key=src.sched._rank,
                              reverse=True):
                if moved >= self.cfg.migrate_per_round:
                    break
                hr = {i: self._headroom(self.engines[i]) for i in live}
                dst_i = max(hr, key=lambda i: hr[i])
                dst = self.engines[dst_i]
                if dst_i == src_i or hr[dst_i] < max(2 * src_hr, 1):
                    break                    # nowhere meaningfully roomier
                if hr[dst_i] < self._demand_pages(dst, seq) or \
                        not self._can_place(src, dst, seq):
                    continue                 # this one does not fit; a
                    #                          smaller one behind it might
                src.sched.release_waiting(seq)
                dst.sched.adopt(seq)
                if seq.req.trace is not None:
                    seq.req.trace.stamp("migrated")
                self.home[seq.req.uid] = dst_i
                self._c_migrations.inc()
                self.metrics.event("migrated", uid=seq.req.uid,
                                   src=src_i, dst=dst_i)
                moved += 1
                src_hr = self._headroom(src)
        return moved

    # -- fault tolerance -----------------------------------------------------

    def quarantine(self, idx: int, reason: str) -> None:
        """Mark a replica dead and rescue everything it holds; placement
        shrinks to the survivors until ``revive()``."""
        if idx in self.dead:
            return
        self.dead.add(idx)
        if self.watchdog is not None:
            self.watchdog.mark_dead(idx)
        self._c_quarantined.inc()
        self._g_dead.set(len(self.dead))
        self.spans.instant("quarantine", replica_idx=idx, reason=reason)
        self.metrics.event("quarantined", replica=idx, reason=reason)
        self._rescue(idx)

    def _adoption_target(self, src_i: int, seq: Sequence) -> Optional[int]:
        order = sorted(self._live(),
                       key=lambda i: -self._headroom(self.engines[i]))
        for i in order:
            if self._can_place(self.engines[src_i], self.engines[i], seq):
                return i
        return None

    def _rescue(self, idx: int) -> None:
        """Move every sequence off a quarantined replica. Running ones
        lost their device state with the replica and are replayed;
        waiting ones hold at most a host-side snapshot and are re-homed
        through the migration hand-off. Exactly once: a request is in
        one scheduler at a time (release before adopt or submit), and a
        replay never truncates ``out_tokens`` (serving/ft.py)."""
        eng = self.engines[idx]
        for seq in list(eng.sched.running):
            eng.sched.release_running(seq)
            self._replay(seq.req, idx)
        for seq in list(eng.sched.waiting):
            eng.sched.release_waiting(seq)
            if seq.req.uid < 0:              # a stale revive probe
                continue
            dst_i = self._adoption_target(idx, seq)
            if dst_i is not None:
                self.engines[dst_i].sched.adopt(seq)
                self.home[seq.req.uid] = dst_i
                self._c_rescued.inc()
                if seq.req.trace is not None:
                    seq.req.trace.stamp("rescued")
                self.spans.instant("rescue", uid=seq.req.uid,
                                   src=idx, dst=dst_i)
                self.metrics.event("rescued", uid=seq.req.uid,
                                   src=idx, dst=dst_i)
            else:
                # a geometry mismatch pins the snapshot here; dropping it
                # and re-prefilling elsewhere beats losing the request
                seq.snapshot = None
                seq.snapshot_pages = []
                self._replay(seq.req, idx)

    def _replay(self, req: Request, src_i: int) -> None:
        """Re-submit a request whose device state is gone: the emitted
        tokens become a forced prompt prefix, so a survivor re-prefills
        and greedy decode goes on where it stopped; ``out_tokens`` is
        untouched, so no token is emitted twice."""
        if req.retries >= req.max_retries:
            self._fail(req, f"retry budget exhausted "
                            f"({req.retries}/{req.max_retries})")
            return
        hwm = ft_lib.fold_emitted_prefix(req)
        # affinity counts double for replays: the folded prompt carries
        # every emitted token, so a survivor holding the original prefix
        # skips most of the re-prefill the failure forced
        order = sorted(self._live(),
                       key=lambda i: -(self._headroom(self.engines[i])
                                       + self._affinity_pages(
                                           self.engines[i], req)))
        for dst_i in order:
            eng = self.engines[dst_i]
            if not eng.sched.fits(req):
                continue
            req.retries += 1
            eng.submit(req)
            self.home[req.uid] = dst_i
            self._c_replayed.inc()
            if req.trace is not None:
                req.trace.stamp("replayed")
            self.spans.instant("replay", uid=req.uid, src=src_i,
                               dst=dst_i, prefix_tokens=hwm)
            self.metrics.event("replayed", uid=req.uid, src=src_i,
                               dst=dst_i, prefix_tokens=hwm)
            return
        self._fail(req, "no live replica can hold the request")

    def _fail(self, req: Request, why: str) -> None:
        req.done = True
        req.finish_reason = "failed"
        now = time.perf_counter()
        req.t_done = now
        if req.trace is not None:
            req.trace.stamp("done", now)
        self._c_failed.inc()
        self.spans.instant("rescue_failed", uid=req.uid, reason=why)
        self.metrics.event("rescue_failed", uid=req.uid, reason=why)

    def revive(self, idx: int) -> bool:
        """Probe a quarantined replica and rejoin it to placement when the
        probe completes. The fault must have been repaired (a host
        swapped; in tests ``ChaosEngine.heal()``); a failed probe keeps
        the replica dead, and may be retried."""
        if idx not in self.dead:
            return True
        eng = self.engines[idx]
        probe = ft_lib.make_probe(
            eng.cfg, uid=-(idx + 1),
            max_new=self.ft.probe_max_new if self.ft is not None else 2)
        try:
            eng.submit(probe)
            for _ in range(256):
                if not eng.sched.has_work:
                    break
                eng.step()
            ok = probe.done and len(probe.out_tokens) >= 1
        except Exception as e:              # noqa: BLE001 (the verdict)
            self.metrics.event("probe_failed", replica=idx,
                               error=f"{type(e).__name__}: {e}")
            ok = False
        if ok:
            self.dead.discard(idx)
            if self.watchdog is not None:
                self.watchdog.revive(idx)
            self._c_revived.inc()
            self._g_dead.set(len(self.dead))
            self.spans.instant("revive", replica_idx=idx)
            self.metrics.event("revived", replica=idx)
        return ok

    def _update_degraded(self) -> None:
        """Sustained pool exhaustion (every live replica backlogged with
        no discounted headroom for ``degraded_rounds`` rounds) flips the
        router to ``degraded``; the first round with headroom flips it
        back."""
        live = self._live()
        backlog = any(self.engines[i].sched.waiting for i in live)
        exhausted = bool(live) and backlog and all(
            self._headroom(self.engines[i]) <= 0 for i in live)
        self._exhausted_rounds = self._exhausted_rounds + 1 \
            if exhausted else 0
        if self.state == "ok" and \
                self._exhausted_rounds >= self.ft.degraded_rounds:
            self.state = "degraded"
            self._g_degraded.set(1)
            self.metrics.event("degraded", rounds=self._exhausted_rounds)
        elif self.state == "degraded" and not exhausted:
            self.state = "ok"
            self._g_degraded.set(0)
            self.metrics.event("recovered")

    # -- driving -------------------------------------------------------------

    @property
    def has_work(self) -> bool:
        return any(self.engines[i].sched.has_work for i in self._live())

    def step(self) -> bool:
        """One round: each busy live replica takes one engine step (with
        ``ft``, watched and guarded against exceptions), then one
        migration pass. Returns whether anything progressed."""
        progressed = False
        for i in list(self._live()):
            eng = self.engines[i]
            had_work = eng.sched.has_work
            stepped = False
            if had_work:
                try:
                    stepped = eng.step()
                except Exception as e:      # noqa: BLE001 (replica loss)
                    if self.ft is None:
                        raise
                    self.quarantine(
                        i, f"exception escaped Engine.step: "
                           f"{type(e).__name__}: {e}")
                    progressed = True       # the rescue moved real work
                    continue
                progressed = stepped or progressed
            if self.watchdog is not None:
                dt = self.watchdog.poll_step_time(i, eng)
                verdict = self.watchdog.observe(i, dt, stepped, had_work)
                # never quarantine the LAST live replica on the
                # watchdog's word: slow beats dead (an exception still
                # quarantines above)
                if verdict is not None and len(self._live()) > 1:
                    self.quarantine(i, verdict)
                    progressed = True
        if self.migrate() > 0:
            progressed = True
        if self.ft is not None:
            self._update_degraded()
        self._c_steps.inc()
        for i, hr in enumerate(self.pressure()):
            self._g_headroom.labels(replica=i).set(hr)
        return progressed

    def run(self, on_step=None) -> List[Request]:
        """Drain every submitted request; returns the completed ones.
        ``on_step(router)`` is called after every round (the periodic
        reporter's hook)."""
        tracked = [s.req for e in self.engines
                   for s in e.sched.waiting + e.sched.running]
        stall = 0
        while self.has_work:
            progressed = self.step()
            if on_step is not None:
                on_step(self)
            stall = 0 if progressed else stall + 1
            if stall > 2 + len(self.engines):
                free = [(e.free_pages, e.free_slots) for e in self.engines]
                raise RuntimeError(
                    f"router stalled: no replica can place the remaining "
                    f"requests (free (pages, slots) per replica: {free})")
        return [r for r in tracked if r.done]

    def describe(self) -> Dict:
        return {"replicas": len(self.engines),
                "dead": sorted(self.dead),
                "state": self.state,
                "free_pages": [e.free_pages for e in self.engines],
                "free_fraction": [round(e.free_fraction, 3)
                                  for e in self.engines],
                "per_engine_stats": [dict(e.stats) for e in self.engines],
                **{k: v for k, v in self.stats.items()}}
