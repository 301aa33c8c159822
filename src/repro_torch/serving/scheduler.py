"""Continuous-batching scheduler: admission, chunked prefill, FCFS or
priority ordering, and preemption-by-eviction.

Replaces the old lock-step slot loop. Requests wait in an admission
queue until the shared :class:`~repro_torch.serving.blocks.BlockAllocator` can
hold their prompt; admitted sequences prefill in fixed-size chunks
(bounding any single step's cost, so a long prompt cannot stall decode
for everyone), then join the batched decode set. When decode needs a
page the pool cannot supply, the lowest-ranked running sequence is
evicted: its pages are snapshotted to host memory (copy-on-preempt),
freed, and the sequence re-enters the admission queue to be swapped back
in later — no work is lost.

Page accounting is MIXED-GEOMETRY per request, driven by the config's
:class:`~repro_torch.serving.paged_cache.PoolPlan`: the *paged* domain holds
``ceil(len / page_size)`` growable pages (kv / mla attention state), the
*slot* domain holds exactly one constant-size slot (srf / ssd states and
the enc-dec encoder memory). A dense model uses pages only, a pure
SSM/SRF model slots only, and a hybrid or enc-dec request owns both — a
request is admitted only when BOTH domains can supply it, and eviction /
completion returns both.

The scheduler is pure host-side bookkeeping; the engine owns device
state and tells the scheduler what happened.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import spans as obs_spans

from .blocks import BlockAllocator, BlockTable
from .prefix import cow


@dataclass(frozen=True)
class SchedConfig:
    max_batch: int = 8          # decode rows per step (jit shape)
    prefill_batch: int = 4      # prefill rows per step
    prefill_chunk: int = 16     # tokens per prefill chunk
    page_size: int = 16
    num_pages: int = 64         # paged-domain pages incl. reserved null page
    table_width: int = 8        # M: max pages per request
    num_slots: int = 0          # slot-domain slots incl. reserved null slot
                                # (0: derive max_batch + 1; unused when the
                                # plan has no constant-state component)
    policy: str = "fcfs"        # fcfs | priority


def tenant_of(req) -> str:
    """Metric label value for a request's tenant namespace. The default
    (unset) namespace is ``"-"`` so the label is never empty."""
    return getattr(req, "namespace", "") or "-"


@dataclass
class Sequence:
    """Scheduler-side state of one request."""
    req: object                       # serving.engine.Request
    arrival: int
    table: BlockTable = field(default_factory=BlockTable)
    slot: Optional[int] = None        # constant-state slot id (plan.needs_slot)
    prefill_pos: int = 0              # prompt tokens already cached
    snapshot: Optional[object] = None  # host pages while preempted
    snapshot_pages: List[int] = field(default_factory=list)
    # -- prefix sharing (serving/prefix) --
    ns: int = 0                       # cache namespace (enc-dec: enc hash)
    hit_tokens: int = 0               # prompt tokens served from the cache
    shared_pages: List[int] = field(default_factory=list)
    fork: Optional[cow.Fork] = None   # pending COW copy (engine applies)
    state_payload: Optional[object] = None  # donor slot-state to restore

    @property
    def prompt_len(self) -> int:
        return len(self.req.prompt)

    @property
    def prefill_done(self) -> bool:
        return self.prefill_pos >= self.prompt_len


class Scheduler:
    """``plan`` is the config's :class:`~repro_torch.serving.paged_cache.PoolPlan`
    (anything exposing ``has_paged`` / ``needs_slot`` works)."""

    def __init__(self, cfg: SchedConfig, plan, metrics=None,
                 labels: Optional[Dict[str, str]] = None, spans=None):
        self.cfg = cfg
        self.plan = plan
        self.spans = spans if spans is not None else obs_spans.NOOP
        self.alloc = BlockAllocator(cfg.num_pages, cfg.page_size)
        self.num_slots = 0
        self.slot_alloc: Optional[BlockAllocator] = None
        if plan.needs_slot:
            self.num_slots = max(cfg.num_slots or (cfg.max_batch + 1), 2)
            self.slot_alloc = BlockAllocator(self.num_slots, 1)
        self.waiting: List[Sequence] = []
        self.running: List[Sequence] = []
        self._arrivals = 0
        self.prefix = None                # PrefixCache (engine attaches)
        self._init_metrics(metrics, labels)

    def attach_prefix(self, cache) -> None:
        """Attach the engine's :class:`~repro_torch.serving.prefix.PrefixCache`
        (it shares ``self.alloc``): admission becomes prefix-aware and
        allocator pressure can evict cache entries. The cache reports
        back whenever it changes the pool so the scheduler's page gauges
        stay truthful."""
        self.prefix = cache
        cache.on_pool_change = self._sync_gauges

    # -- metrics -------------------------------------------------------------

    def _init_metrics(self, metrics, labels) -> None:
        """Counters/gauges in the shared registry; ``self.stats`` is a
        read-only compat view over them (PRs 1-5 exposed a plain dict).
        The engine passes its registry and ``{"engine": id}`` label so a
        router deployment reads every replica from ONE registry; a
        scheduler built standalone (tests) gets a private registry."""
        self.metrics = metrics if metrics is not None \
            else obs_metrics.MetricsRegistry()
        labels = dict(labels or {"engine": "-"})
        self._labels = labels
        ln = tuple(labels)
        c = lambda name, help: self.metrics.counter(  # noqa: E731
            name, help, ln).labels(**labels)
        g = lambda name, help: self.metrics.gauge(    # noqa: E731
            name, help, ln).labels(**labels)
        self._c_submitted = c("sched_submitted_total", "requests submitted")
        self._c_admitted = c("sched_admitted_total", "admissions (incl. "
                             "swap-ins of preempted sequences)")
        self._c_finished = c("sched_finished_total", "requests finished")
        self._c_preempted = c("sched_preemptions_total", "evictions")
        self._c_defrags = c("sched_defrags_total", "defrag passes")
        self._c_released = c("sched_released_total",
                             "sequences released for migration")
        self._c_adopted = c("sched_adopted_total",
                            "sequences adopted from another replica")
        self._c_expired = c("sched_expired_total",
                            "waiting sequences expired past deadline")
        self._g_waiting = g("sched_waiting", "sequences in admission queue")
        self._g_running = g("sched_running", "sequences holding capacity")
        self._g_free_pages = g("sched_free_pages", "paged-domain free pages")
        self._g_used_pages = g("sched_used_pages", "paged-domain used pages")
        self._g_free_slots = g("sched_free_slots", "slot-domain free slots")
        self._g_used_slots = g("sched_used_slots", "slot-domain used slots")
        # per-tenant fairness substrate: pages currently held by RUNNING
        # sequences, broken down by the request's namespace (vanished
        # tenants are zeroed, not deleted — scrapes see the drop)
        self._g_tenant_pages = self.metrics.gauge(
            "tenant_pages_held", "paged-domain pages held by running "
            "sequences, by tenant namespace", ln + ("tenant",))
        self._tenant_page_children: Dict[str, object] = {}
        self.stats = obs_metrics.StatsView({
            "admitted": self._c_admitted.value,
            "preemptions": self._c_preempted.value,
            "defrags": self._c_defrags.value,
            "submitted": self._c_submitted.value,
            "finished": self._c_finished.value,
        })
        self._sync_gauges()

    def _sync_gauges(self) -> None:
        self._g_waiting.set(len(self.waiting))
        self._g_running.set(len(self.running))
        self._g_free_pages.set(self.alloc.free_pages)
        self._g_used_pages.set(self.alloc.used_pages)
        if self.slot_alloc is not None:
            self._g_free_slots.set(self.slot_alloc.free_pages)
            self._g_used_slots.set(self.slot_alloc.used_pages)
        held: Dict[str, int] = {}
        for seq in self.running:
            t = tenant_of(seq.req)
            held[t] = held.get(t, 0) + len(seq.table.pages)
        for t, n in held.items():
            ch = self._tenant_page_children.get(t)
            if ch is None:
                ch = self._g_tenant_pages.labels(
                    **dict(self._labels, tenant=t))
                self._tenant_page_children[t] = ch
            ch.set(n)
        for t, ch in self._tenant_page_children.items():
            if t not in held:
                ch.set(0)

    # -- ordering -----------------------------------------------------------

    def _rank(self, seq: Sequence) -> Tuple:
        """Sort key: best-to-schedule first, deadline-aware (EDF): among
        equal priority, deadlined sequences come before deadline-less
        ones, earliest deadline first. The key is also what
        ``_victim_order`` reverses, so deadlined work is evicted LAST.
        Non-deadlined requests keep the pre-deadline ordering exactly
        (their EDF component is the constant ``(1, 0.0)``)."""
        da = getattr(seq.req, "deadline_at", None)
        edf = (0, da) if da is not None else (1, 0.0)
        if self.cfg.policy == "priority":
            return (-getattr(seq.req, "priority", 0), *edf, seq.arrival)
        return (*edf, seq.arrival)

    def _victim_order(self) -> List[Sequence]:
        """Worst-to-keep first (reverse of schedule rank)."""
        return sorted(self.running, key=self._rank, reverse=True)

    # -- submission / admission --------------------------------------------

    def fits(self, req) -> bool:
        """Whether this scheduler's pool geometry can ever hold the
        request (the admission capacity rule; shared with the router so
        the two cannot drift). Slot-domain state is constant-size, so
        only the paged component bounds the token budget."""
        if not self.plan.has_paged:
            return True
        return len(req.prompt) + self._remaining_new(req) <= \
            self.cfg.table_width * self.cfg.page_size

    @staticmethod
    def _remaining_new(req) -> int:
        """Tokens the request can still emit. A replica-failure replay
        folds emitted tokens into the prompt without truncating
        ``out_tokens`` (serving/ft.py), so its total budget at finish is
        unchanged — counting the full ``max_new`` again would double the
        emitted prefix and reject rescues that actually fit."""
        emitted = len(getattr(req, "out_tokens", ()) or ())
        return max(1, req.max_new - emitted)

    def submit(self, req) -> Sequence:
        if len(req.prompt) == 0:
            raise ValueError("empty prompt (need >= 1 token to prefill)")
        if not self.fits(req):
            cap = self.cfg.table_width * self.cfg.page_size
            need = len(req.prompt) + self._remaining_new(req)
            raise ValueError(f"request needs {need} "
                             f"tokens > capacity {cap}")
        seq = Sequence(req=req, arrival=self._arrivals)
        self._arrivals += 1
        self.waiting.append(seq)
        self._c_submitted.inc()
        self._g_waiting.set(len(self.waiting))
        return seq

    def _pages_for(self, n_tokens: int) -> int:
        if not self.plan.has_paged:
            return 0
        return max(1, -(-n_tokens // self.cfg.page_size))

    def _alloc_pages(self, n: int) -> Optional[List[int]]:
        """Allocate, evicting prefix-cache entries under pressure: the
        cache is elastic capacity — LRU unpinned leaves are dropped until
        the allocation fits or the cache runs dry."""
        pages = self.alloc.alloc(n)
        if pages is None and self.prefix is not None and \
                self.prefix.evict_for(n - self.alloc.free_pages) > 0:
            pages = self.alloc.alloc(n)
        return pages

    def _lookup_prefix(self, seq: Sequence) -> Optional[cow.PrefixMatch]:
        """Prefix-cache lookup for a FRESH admission (a preemption
        snapshot already has its exact pages; restoring shared content
        into them would alias nothing anyway). Slot-bearing plans only
        match at a donor's state point — the cache enforces that."""
        if self.prefix is None or seq.snapshot is not None \
                or not self.plan.has_paged:
            return None
        return self.prefix.lookup(seq.ns, seq.req.prompt,
                                  want_state=bool(self.plan.slot_families),
                                  tenant=tenant_of(seq.req),
                                  uid=seq.req.uid)

    def admit(self) -> List[Sequence]:
        """Move waiting sequences into the running set while BOTH domains
        can supply them (pages for the prompt, one constant-state slot).
        Returns ALL newly admitted sequences; the engine must swap pages
        back in for those carrying a preemption snapshot and zero the
        (possibly previously used) slots of fresh admits — srf/ssd states
        are accumulators, so a stale slot is live garbage, not masked-out
        history like a stale KV row.

        With a prefix cache attached, a fresh admission is charged only
        its UNSHARED pages: the matched prefix's full pages join the
        request's table as read-only shared references, prefill resumes
        at the match boundary, and an unaligned boundary page is
        scheduled for a COW fork into the request's first fresh page
        (the engine applies the device copy; see serving/prefix). A
        failed admission releases the match's pins — next round re-looks
        it up against a possibly changed cache."""
        tok = self.spans.begin("admit")
        admitted = []
        for seq in sorted(self.waiting, key=self._rank):
            if len(self.running) >= self.cfg.max_batch:
                break
            match = None
            if seq.snapshot is not None:
                n = len(seq.snapshot_pages)
            else:
                match = self._lookup_prefix(seq)
                n = self._pages_for(max(seq.prompt_len, 1)) \
                    - (len(match.pages) if match is not None else 0)
            pages = self._alloc_pages(n)
            if pages is None:
                if match is not None:
                    self.prefix.release(match)
                break                    # head-of-line blocks (no starvation)
            if self.slot_alloc is not None:
                slot = self.slot_alloc.alloc(1)
                if slot is None:
                    self.alloc.free(pages)
                    if match is not None:
                        self.prefix.release(match)
                    break                # slot domain exhausted: same rule
                seq.slot = slot[0]
            if match is not None and match.tokens > 0:
                # shared prefix pages lead the table; ownership of the
                # pins transfers to the table (released uniformly later)
                seq.table.pages = list(match.pages) + pages
                seq.shared_pages = list(match.pages)
                seq.prefill_pos = match.tokens
                seq.table.length = match.tokens
                seq.hit_tokens = match.tokens
                seq.state_payload = match.payload
                if match.fork_src is not None:
                    seq.fork = cow.Fork(match.fork_src, pages[0],
                                        pinned_src=True)
            else:
                seq.table.pages = pages
            self.waiting.remove(seq)
            self.running.append(seq)
            self._c_admitted.inc()
            admitted.append(seq)
        if admitted:
            self._sync_gauges()
        tok.args["admitted"] = len(admitted)
        tok.args["waiting"] = len(self.waiting)
        self.spans.end(tok)
        return admitted

    # -- prefill ------------------------------------------------------------

    def prefill_work(self) -> List[Sequence]:
        todo = [s for s in self.running if not s.prefill_done]
        return sorted(todo, key=self._rank)[: self.cfg.prefill_batch]

    # -- decode -------------------------------------------------------------

    def decode_ready(self) -> List[Sequence]:
        rdy = [s for s in self.running if s.prefill_done]
        return sorted(rdy, key=self._rank)[: self.cfg.max_batch]

    def grow_for_decode(self, seq: Sequence) -> Tuple[bool, Optional[Sequence]]:
        """Ensure ``seq`` has a page for its next token. Returns
        (ok, victim): when the pool is exhausted the chosen victim must be
        evicted by the engine (its pages snapshotted + freed) before the
        decode step; ``ok`` is False if seq itself must stall this step.
        Constant-state-only plans never grow (the slot is the state)."""
        if not self.plan.has_paged:
            return True, None
        need = seq.table.pages_needed(seq.table.length + 1,
                                      self.cfg.page_size)
        if need <= 0:
            # the next token lands in an existing page — but if that page
            # is SHARED (prefix-cache / sibling request), writing it would
            # corrupt every other reader: COW-fork it first. The table
            # swaps to the fresh page immediately and this request's
            # reference on the source is dropped — safe because the
            # device copy (engine-applied, batched gather-then-scatter
            # reading pre-copy pools) happens before any write lands.
            pos = seq.table.length
            idx = cow.decode_fork_index(self.alloc, seq.table.pages, pos,
                                        self.cfg.page_size)
            if idx is None:
                return True, None
            pages = self._alloc_pages(1)
            if pages is not None:
                src = seq.table.pages[idx]
                seq.fork = cow.Fork(src, pages[0], pinned_src=False)
                seq.table.pages[idx] = pages[0]
                self.alloc.free([src])
                self._g_free_pages.set(self.alloc.free_pages)
                self._g_used_pages.set(self.alloc.used_pages)
                return True, None
        else:
            if len(seq.table.pages) + need > self.cfg.table_width:
                return False, None       # at capacity: request finishes soon
            pages = self._alloc_pages(need)
            if pages is not None:
                seq.table.pages.extend(pages)
                self._g_free_pages.set(self.alloc.free_pages)
                self._g_used_pages.set(self.alloc.used_pages)
                return True, None
        for victim in self._victim_order():
            if victim is not seq:
                return False, victim
        return False, None

    # -- eviction / completion ---------------------------------------------

    def _release(self, seq: Sequence) -> None:
        self.alloc.free(seq.table.pages)
        seq.table.pages = []
        seq.shared_pages = []
        if seq.slot is not None:
            self.slot_alloc.free([seq.slot])
            seq.slot = None

    def evicted(self, seq: Sequence, snapshot) -> None:
        """Engine snapshotted ``seq``'s pages+slot; return them, requeue."""
        seq.snapshot = snapshot
        seq.snapshot_pages = list(seq.table.pages)
        self._release(seq)
        self.running.remove(seq)
        self.waiting.append(seq)
        self._c_preempted.inc()
        self._sync_gauges()

    def restored(self, seq: Sequence) -> None:
        seq.snapshot = None
        seq.snapshot_pages = []

    def finished(self, seq: Sequence) -> None:
        self._release(seq)
        self.running.remove(seq)
        self._c_finished.inc()
        self._sync_gauges()

    # -- cross-replica migration (serving.mesh.router) ----------------------

    def expire_overdue(self, now: float) -> List[Sequence]:
        """Drop WAITING sequences past their deadline and hand them to
        the engine for terminal ``timeout`` bookkeeping. Waiting
        sequences hold no device capacity, so expiry frees nothing —
        but it does stop a backlogged pool from spending pages on work
        that is already late. Running sequences are never expired (their
        pages are bought; finishing them is strictly cheaper than
        re-serving). Expired counts land in ``finished_total`` too, so
        the conservation identity (submitted + adopted == finished +
        released + running + waiting) is untouched;
        ``sched_expired_total`` tells the timeout story apart."""
        out = [s for s in self.waiting
               if getattr(s.req, "deadline_at", None) is not None
               and now > s.req.deadline_at]
        for seq in out:
            self.waiting.remove(seq)
            seq.snapshot = None
            seq.snapshot_pages = []
            self._c_finished.inc()
            self._c_expired.inc()
            self.spans.instant("expired", uid=seq.req.uid,
                               tenant=tenant_of(seq.req))
        if out:
            self._g_waiting.set(len(self.waiting))
        return out

    def release_running(self, seq: Sequence) -> None:
        """Drop a RUNNING sequence whose device state is gone (its
        replica died): both domains are freed locally and the request is
        handed back to the router for replay elsewhere. Counted as
        released — the conservation identity absorbs the hand-off
        exactly like ``release_waiting``."""
        self._release(seq)
        self.running.remove(seq)
        self._c_released.inc()
        self._sync_gauges()

    def release_waiting(self, seq: Sequence) -> None:
        """Detach a waiting sequence so another replica can adopt it.
        Waiting sequences hold no pages or slots (fresh or evicted-with-
        snapshot), so nothing device-side needs to move with them."""
        self.waiting.remove(seq)
        self._c_released.inc()
        self._g_waiting.set(len(self.waiting))

    def adopt(self, seq: Sequence) -> None:
        """Take over a sequence released by another replica's scheduler.
        Prefill progress and any preemption snapshot travel with it (the
        snapshot is host memory and pool shapes match across replicas);
        arrival is restamped so local FCFS ordering stays coherent."""
        seq.arrival = self._arrivals
        self._arrivals += 1
        self.waiting.append(seq)
        self._c_adopted.inc()
        self._g_waiting.set(len(self.waiting))

    def defrag(self):
        """Compact live pages to the low end of the paged pool. Returns
        the {old: new} move map; the engine must apply it to the device
        pools AND the scheduler rewrites the block tables here. Slots
        never fragment (one per request)."""
        moves = self.alloc.defrag_plan()
        if moves:
            for seq in self.running:
                seq.table.pages = [moves.get(p, p) for p in seq.table.pages]
            if self.prefix is not None:
                self.prefix.remap(moves)
            self._c_defrags.inc()
        return moves

    @property
    def free_slots(self) -> int:
        return self.slot_alloc.free_pages if self.slot_alloc else 0

    @property
    def has_work(self) -> bool:
        return bool(self.waiting or self.running)
