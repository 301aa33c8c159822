"""Paged continuous-batching serving engine (dense, SSD, hybrid and MoE
families; full-KV, MLA or SRF attention).

Port of ``repro.serving.engine``: requests share pooled, pre-allocated
caches (``paged_cache``): full-KV or MLA latent pages indexed through
per-request block tables (``blocks``), and one constant-size slot per
request for the SRF and SSD states; a hybrid request holds both.
The scheduler (a copy of the reference's) handles admission, chunked
prefill and preemption; prefill and decode both run as batched
``transformer.paged_step`` calls with fixed shapes (prefill_batch x
chunk, max_batch x 1), inactive rows masked onto the null page / slot 0.
Sampling is stateless (``sampler.sample_stateless``): row noise keyed by
(engine seed, uid, emitted-token index), greedy where temperature is 0.
Seeded-SRF configs (``SRFAttnConfig(seeded=True)``) take a per-request
``embed_seed`` that personalizes every SRF projection (0 = the base
projection), passed into every step.

``paged=PagedConfig(quantize_kv=True)`` stores KV pages as int8 with one
f32 scale per token; ``prefix=PrefixConfig(...)`` shares the KV pages of
cached prompt prefixes across requests (radix trie, copy-on-write forks,
chunked prefill; ``serving/prefix``); a slot-bearing plan with pages
(hybrid) also caches the donor's slot state at the prompt's end and
restores it into a hit's slot. Preempted requests' pages and
slots are snapshotted to pinned host memory and restored at
re-admission. An SRF engine samples the live quality probe
(``obs/quality``) at its first decode step and every ``quality_every``
decode steps after it, into the ``srf_quality`` gauge.

Telemetry is the reference's: the engine's counters and histograms, the
per-tenant counters (``tenant_{prefill_tokens,decode_tokens,requests,
expired}_total`` with ``{engine, tenant}`` labels), the ``pool_bytes``
and ``pool_bytes_per_device`` gauges (equal: one card holds every
pool), the registry events ``queued``, ``restored``, ``prefix_hit``,
``expired``, ``done`` and ``preempted``, and, given ``spans=``, the
spans ``engine_step``, ``prefill_step``, ``decode_step`` and ``sample``
with the instants ``prefill_chunk``, ``cow_fork``, ``cache_tail_copy``
and ``preempt`` (the scheduler, prefix cache and chunk policy record
into the same recorder).

Not ported yet, and refused if asked for: mesh-sharded pools and enc-dec
memories.
"""
from __future__ import annotations

import hashlib
import itertools
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.kernels import seedgen
from repro_torch.models import attention as attn_lib
from repro_torch.models import transformer as model_lib
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import quality as obs_quality
from repro_torch.obs import spans as obs_spans
from repro_torch.obs import trace as obs_trace

from . import paged_cache
from .prefix import ChunkPolicy, PrefixCache, PrefixConfig, cow
from .sampler import sample_stateless
from .scheduler import SchedConfig, Scheduler, Sequence, tenant_of


@dataclass
class Request:
    uid: int
    prompt: np.ndarray               # (P,) int32
    max_new: int = 32
    eos_id: int = -1                 # -1: never
    priority: int = 0                # higher first (policy="priority")
    temperature: float = 0.0         # 0 = greedy
    top_k: int = 0
    top_p: float = 1.0
    embed_seed: int = 0              # seeded-SRF configs: personalized
    #                                  projection seed (0 = base projection)
    enc_emb: Optional[np.ndarray] = None  # enc-dec input (not ported)
    deadline: Optional[float] = None # seconds after submit; overdue WAITING
    #                                  requests finish as 'timeout'
    max_retries: int = 2             # replica-failure rescue budget
    namespace: str = ""              # tenant id
    out_tokens: List[int] = field(default_factory=list)
    done: bool = False
    finish_reason: str = ""          # eos | length | timeout | shed | failed
    retries: int = 0                 # rescues consumed (ft router)
    deadline_at: Optional[float] = None
    t_submit: float = 0.0            # perf_counter stamps
    t_first: float = 0.0
    t_done: float = 0.0
    trace: Optional[obs_trace.Trace] = None


def _default_sched(cfg, batch_slots: int, max_len: int, plan,
                   policy: str) -> SchedConfig:
    """The reference's default geometry."""
    page = 16 if max_len >= 64 else 8
    if not plan.has_paged:
        # constant-state only: the slot domain is the whole geometry
        return SchedConfig(max_batch=batch_slots, prefill_batch=batch_slots,
                           prefill_chunk=min(32, max(8, page)),
                           page_size=page, num_pages=2, table_width=1,
                           num_slots=batch_slots + 1, policy=policy)
    width = max(1, -(-max_len // page))
    return SchedConfig(max_batch=batch_slots, prefill_batch=batch_slots,
                       prefill_chunk=min(32, 2 * page), page_size=page,
                       num_pages=2 * batch_slots * width + 1,
                       table_width=width, num_slots=batch_slots + 1,
                       policy=policy)


def _cache_namespace(req, seeded_srf: bool = False) -> int:
    """Prefix-cache trie namespace of a request: partitioned by tenant
    (requests of different namespaces never share cache state); the
    default tenant is ``0``. ``seeded_srf`` engines also partition by
    ``embed_seed``: personalized projections make different attention
    states of the same tokens. (The reference also partitions by enc-dec
    encoder content; the port refuses enc-dec requests.)"""
    ns = 0
    tenant = getattr(req, "namespace", "")
    if tenant:
        h = hashlib.blake2b(tenant.encode("utf-8"), digest_size=8)
        ns ^= int.from_bytes(h.digest(), "big")
    if seeded_srf:
        es = getattr(req, "embed_seed", 0)
        if es:
            h = hashlib.blake2b(int(es).to_bytes(8, "big", signed=False),
                                digest_size=8)
            ns ^= int.from_bytes(h.digest(), "big")
    return ns


_ENGINE_IDS = itertools.count()


class Engine:
    """Continuous batching over pooled caches on ``device``.

    ``batch_slots`` and ``max_len`` size the default geometry; pass
    ``sched=SchedConfig(...)`` to size the pools explicitly (e.g. tight
    pools to exercise preemption). ``paged`` and ``prefix`` as in the
    module docstring; ``prefix`` is silently off for a plan with no
    paged domain (SRF, SSD), which has no pages to share. ``seed`` keys the
    sampling noise (the key of ``jax.random.PRNGKey(seed)`` in the
    reference); it never advances. ``quality_every`` (SRF configs only;
    0 = off) and ``quality_tol`` drive the live quality probe.
    ``spans`` (an ``obs.spans.SpanRecorder``) records the step timeline;
    without it nothing is recorded."""

    def __init__(self, cfg, params, batch_slots: int = 4,
                 max_len: int = 512, sched: Optional[SchedConfig] = None,
                 policy: str = "fcfs", seed: int = 0,
                 metrics: Optional[obs_metrics.MetricsRegistry] = None,
                 device="cuda", mesh=None,
                 paged: Optional[paged_cache.PagedConfig] = None,
                 prefix: Optional[PrefixConfig] = None,
                 quality_every: int = 64,
                 quality_tol: float = obs_quality.DRIFT_TOL,
                 spans: Optional[obs_spans.SpanRecorder] = None):
        if mesh is not None:
            raise NotImplementedError(f"mesh-sharded serving is "
                                      f"{attn_lib.NOT_IN_SLICE}")
        self.cfg = cfg
        self.device = torch.device(device)
        self.plan = paged_cache.plan_for(cfg)
        self.paged = paged or paged_cache.PagedConfig()
        self.metrics = metrics if metrics is not None \
            else obs_metrics.MetricsRegistry()
        self.spans = spans if spans is not None else obs_spans.NOOP
        self.engine_id = str(next(_ENGINE_IDS))
        if sched is None:
            sched = _default_sched(cfg, batch_slots, max_len, self.plan,
                                   policy)
        self.sched_cfg = sched
        self.sched = Scheduler(sched, self.plan, metrics=self.metrics,
                               labels={"engine": self.engine_id},
                               spans=self.spans)
        self.pools = paged_cache.init_pools(cfg, sched.num_pages,
                                            sched.page_size,
                                            num_slots=self.sched.num_slots,
                                            device=self.device,
                                            paged=self.paged)
        self.params = params
        # stateless sampling: the base key never advances; row noise is
        # keyed by fold_in(fold_in(base, uid), position)
        self._base_key = seedgen.threefry_seed(seed, self.device)
        self._seeded_srf = cfg.attn_impl == "srf" and cfg.srf.seeded
        self.clock = time.perf_counter
        self.nonfinite_rows = 0          # sampled logit rows with inf/nan
        self._pending_snaps: List[paged_cache.PendingSnapshot] = []
        # (src, dst) tail-page copies owed to the prefix cache, flushed as
        # one batched copy at the end of the prefill step so donors keep
        # exclusive ownership of their tail pages (no mid-decode forks)
        self._cache_copies: List[Tuple[int, int]] = []
        self.prefix: Optional[PrefixCache] = None
        self._chunk: Optional[ChunkPolicy] = None
        if prefix is not None and prefix.enabled and self.plan.has_paged:
            self.prefix = PrefixCache(
                self.sched.alloc, sched.page_size,
                paged_cache.page_bytes(self.pools), prefix,
                metrics=self.metrics, labels={"engine": self.engine_id},
                spans=self.spans)
            self.sched.attach_prefix(self.prefix)
            self._chunk = ChunkPolicy(prefix.chunk, spans=self.spans)
        self._init_metrics()
        self._quality_every = quality_every if cfg.attn_impl == "srf" else 0
        self._quality_tol = quality_tol
        # primed so the FIRST decode step publishes a sample: short runs
        # (fewer than quality_every steps) still see the live gauge
        self._steps_since_quality = max(0, self._quality_every - 1)

    def _init_metrics(self) -> None:
        lab = {"engine": self.engine_id}
        m = self.metrics
        c = lambda name, help: m.counter(name, help,  # noqa: E731
                                         ("engine",)).labels(**lab)
        h = lambda name, help: m.histogram(           # noqa: E731
            name, help, ("engine",)).labels(**lab)
        self._c_tokens = c("engine_tokens_total", "tokens generated")
        self._c_requests = c("engine_requests_total", "requests finished")
        self._c_prefill_steps = c("engine_prefill_steps_total",
                                  "batched prefill-chunk steps")
        self._c_prefill_tokens = c("engine_prefill_tokens_total",
                                   "prompt tokens prefilled")
        self._c_decode_steps = c("engine_decode_steps_total",
                                 "batched decode steps")
        self._c_preemptions = c("engine_preemptions_total",
                                "copy-on-preempt evictions")
        self._c_expired = c("engine_expired_total",
                            "waiting requests expired past deadline")
        self._c_cow_forks = c("prefix_cow_forks_total",
                              "copy-on-write page forks applied (admission "
                              "boundary + decode divergence)")
        self._h_step = h("engine_step_seconds", "wall time of one engine "
                         "step")
        self._h_ttft = h("request_ttft_seconds", "time to first token")
        self._h_tpot = h("request_tpot_seconds", "per-output-token time "
                         "after the first")
        self._h_queue = h("request_queue_seconds", "submit -> admission")
        self._h_e2e = h("request_e2e_seconds", "submit -> done")
        # per-tenant accounting: same registry, {engine, tenant} labels,
        # children bound on a namespace's first request
        tl = ("engine", "tenant")
        self._ct_prefill = m.counter(
            "tenant_prefill_tokens_total",
            "prompt tokens prefilled, by tenant namespace", tl)
        self._ct_decode = m.counter(
            "tenant_decode_tokens_total",
            "decode tokens generated, by tenant namespace", tl)
        self._ct_requests = m.counter(
            "tenant_requests_total",
            "requests finished, by tenant namespace", tl)
        self._ct_expired = m.counter(
            "tenant_expired_total",
            "requests expired past deadline, by tenant namespace", tl)
        self._tenant_children: Dict[str, Dict[str, object]] = {}
        self.stats = obs_metrics.StatsView({
            "tokens": self._c_tokens.value,
            "requests": self._c_requests.value,
            "prefill_steps": self._c_prefill_steps.value,
            "decode_steps": self._c_decode_steps.value,
            "preemptions": self._c_preemptions.value,
        })
        self._sample_memory_gauges()

    def _tenant(self, req) -> Dict[str, object]:
        """The bound per-tenant counter children of a request's
        namespace (cached)."""
        t = tenant_of(req)
        ch = self._tenant_children.get(t)
        if ch is None:
            lab = {"engine": self.engine_id, "tenant": t}
            ch = {"prefill": self._ct_prefill.labels(**lab),
                  "decode": self._ct_decode.labels(**lab),
                  "requests": self._ct_requests.labels(**lab),
                  "expired": self._ct_expired.labels(**lab)}
            self._tenant_children[t] = ch
        return ch

    def _sample_memory_gauges(self) -> None:
        """Pool-memory gauges: the pools are allocated up front, so the
        bytes are constant per engine (free pages and slots are the
        scheduler's live gauges)."""
        lab = {"engine": self.engine_id}
        self.metrics.gauge("pool_bytes", "total pool bytes (all devices)",
                           ("engine",)).labels(**lab).set(
            paged_cache.pool_bytes(self.pools))
        self.metrics.gauge("pool_bytes_per_device",
                           "pool bytes resident per device",
                           ("engine",)).labels(**lab).set(
            paged_cache.pool_bytes_per_device(self.pools))

    def _maybe_sample_quality(self) -> None:
        """Every ``quality_every`` decode steps, publish the paper's row
        statistics (Def. 1 calibration) of the live SRF params as the
        ``srf_quality`` gauge, and a ``quality_drift`` event when they
        leave ``quality_tol``."""
        if not self._quality_every or not self.metrics.enabled:
            return
        self._steps_since_quality += 1
        if self._steps_since_quality < self._quality_every:
            return
        self._steps_since_quality = 0
        stats = obs_quality.srf_quality_probe(self.cfg, self.params)
        if not stats:
            return
        gq = self.metrics.gauge("srf_quality", "live embedding row "
                                "statistics (Def. 1)", ("engine", "stat"))
        for k, v in stats.items():
            gq.labels(engine=self.engine_id, stat=k).set(v)
        if obs_quality.moments_drifted(stats, self._quality_tol):
            self.metrics.event("quality_drift", engine=self.engine_id,
                               tol=self._quality_tol, **stats)

    # -- public API ---------------------------------------------------------

    def submit(self, req: Request) -> None:
        if req.enc_emb is not None:
            raise NotImplementedError(f"enc-dec serving is "
                                      f"{attn_lib.NOT_IN_SLICE}")
        now = time.perf_counter()
        req.t_submit = now
        if req.deadline is not None and req.deadline_at is None:
            req.deadline_at = now + req.deadline
        if req.trace is None:
            req.trace = obs_trace.Trace(uid=req.uid)
        req.trace.stamp("queued", now)
        self.metrics.event("queued", uid=req.uid, engine=self.engine_id)
        seq = self.sched.submit(req)
        if self.prefix is not None:
            seq.ns = _cache_namespace(req, self._seeded_srf)

    def prefix_peek(self, req: Request) -> int:
        """Tokens of ``req``'s prompt this engine could serve from its
        prefix cache right now (non-pinning, no LRU touch)."""
        if self.prefix is None:
            return 0
        return self.prefix.peek(_cache_namespace(req, self._seeded_srf),
                                req.prompt,
                                want_state=bool(self.plan.slot_families))

    def run(self, on_step=None) -> List[Request]:
        """Drain all submitted requests; returns the completed ones.
        ``on_step(engine)`` is called after every scheduler iteration (the
        reporter's periodic-metrics hook)."""
        tracked = [s.req for s in self.sched.waiting + self.sched.running]
        stall = 0
        while self.sched.has_work:
            progressed = self.step()
            if on_step is not None:
                on_step(self)
            stall = 0 if progressed else stall + 1
            if stall > 2:
                raise RuntimeError(
                    "scheduler stalled: pool too small for the remaining "
                    f"requests (free={self.sched.alloc.free_pages} pages, "
                    f"{self.sched.free_slots} slots)")
        return [r for r in tracked if r.done]

    def step(self) -> bool:
        """One scheduler iteration: admit, then one prefill-chunk step if
        any sequence is still prefilling, else one batched decode step.
        Returns False when nothing could run."""
        t0 = self.clock()
        tok = self.spans.begin("engine_step")
        try:
            return self._step_once()
        finally:
            self.spans.end(tok)
            self._h_step.observe(self.clock() - t0)

    def _step_once(self) -> bool:
        expired = self.sched.expire_overdue(time.perf_counter())
        for seq in expired:
            self._expire(seq)
        admitted = self.sched.admit()
        now = time.perf_counter() if admitted else 0.0
        fresh: List[Sequence] = []
        for seq in admitted:
            seq.req.trace.stamp("admitted", now)
            if seq.snapshot is not None:
                paged_cache.restore_page_rows(self.pools, seq.table.pages,
                                              self._slot_ids(seq),
                                              seq.snapshot)
                self.sched.restored(seq)
                seq.req.trace.stamp("restored", now)
                self.metrics.event("restored", uid=seq.req.uid,
                                   engine=self.engine_id)
            else:
                if seq.hit_tokens > 0:
                    seq.req.trace.stamp("prefix_hit", now)
                    self.metrics.event("prefix_hit", uid=seq.req.uid,
                                       engine=self.engine_id,
                                       tokens=seq.hit_tokens)
                if seq.slot is not None:
                    fresh.append(seq)    # a reused slot starts from zero
        if fresh:
            paged_cache.zero_slot_rows(self.pools, [s.slot for s in fresh])
        self._apply_forks(admitted)
        for seq in admitted:
            if seq.state_payload is not None:
                # the donor's constant state at the matched token count:
                # what makes the shared KV pages resumable for a plan
                # with slots
                paged_cache.restore_page_rows(self.pools, [],
                                              self._slot_ids(seq),
                                              seq.state_payload)
                seq.state_payload = None
        work = self.sched.prefill_work()
        sc = self.sched_cfg
        if work and self._chunk is not None \
                and self.sched.decode_ready() \
                and self._chunk.spans_steps(work, sc.prefill_chunk,
                                            sc.prefill_batch) \
                and self._chunk.decode_turn():
            # chunked-prefill interleave: yield this step to decode so a
            # long cold prompt cannot starve running requests
            if self._decode_step(self.sched.decode_ready()):
                return True
            work = self.sched.prefill_work()    # decode may have evicted
        if work:
            self._prefill_step(work)
            return True
        ready = self.sched.decode_ready()
        if ready:
            return self._decode_step(ready) or bool(expired)
        return bool(admitted) or bool(expired)

    def _apply_forks(self, seqs: List[Sequence]) -> None:
        """Apply pending COW forks as ONE batched copy (``copy_page_rows``
        gathers every source before any write). Admission forks pin their
        source in the cache until the copy is issued; released here."""
        forks = [s.fork for s in seqs if s.fork is not None]
        if not forks:
            return
        paged_cache.copy_page_rows(self.pools, [f.src for f in forks],
                                   [f.dst for f in forks])
        self._c_cow_forks.inc(len(forks))
        self.spans.instant("cow_fork", pages=len(forks))
        for s in seqs:
            if s.fork is not None:
                if s.fork.pinned_src:
                    self.prefix.release_fork(s.fork.src)
                s.fork = None

    @staticmethod
    def _slot_ids(seq: Sequence) -> List[int]:
        return [seq.slot] if seq.slot is not None else []

    def _expire(self, seq: Sequence) -> None:
        req = seq.req
        req.done = True
        req.finish_reason = "timeout"
        req.t_done = time.perf_counter()
        req.trace.stamp("done", req.t_done)
        if req.trace.e2e is not None:
            self._h_e2e.observe(req.trace.e2e)
        self._c_expired.inc()
        self._tenant(req)["expired"].inc()
        self.metrics.event("expired", uid=req.uid, engine=self.engine_id)

    # -- device step ---------------------------------------------------------

    def _fence_snapshots(self) -> None:
        """Wait for pending copy-on-preempt host copies. Pool writes are
        ordered behind the snapshot gathers on the stream already; the
        fence bounds how long pinned host buffers stay in flight (the
        engine syncs with the device every step anyway)."""
        for snap in self._pending_snaps:
            snap.fence()
        self._pending_snaps.clear()

    def _run_step(self, tokens, pos, qv, tables, slots,
                  seqs: List[Optional[Sequence]]) -> torch.Tensor:
        """One ``paged_step``. A seeded-SRF engine passes every row's
        embed seed (``seqs``: the rows' sequences, None = padded) on every
        step, all-zero batches included."""
        self._fence_snapshots()
        dev = self.device
        es = None
        if self._seeded_srf:
            es = torch.from_numpy(self._embed_seeds(seqs)).to(dev)
        logits, self.pools = model_lib.paged_step(
            self.params, self.cfg, self.pools,
            torch.from_numpy(tokens).to(dev), torch.from_numpy(pos).to(dev),
            torch.from_numpy(qv).to(dev), torch.from_numpy(tables).to(dev),
            torch.from_numpy(slots).to(dev), embed_seeds=es)
        return logits

    @staticmethod
    def _embed_seeds(seqs: List[Optional[Sequence]]) -> np.ndarray:
        """(B,) per-row projection seeds as words (0 = base projection;
        padded rows are base)."""
        return np.array([0 if s is None else s.req.embed_seed & 0xFFFFFFFF
                         for s in seqs], np.int64)

    def _sample_rows(self, rows: torch.Tensor,
                     seqs: List[Optional[Sequence]]) -> np.ndarray:
        """Stateless per-request sampling of the rows of ``seqs`` (None =
        padded row, drawn greedy): row i's noise is keyed by (base key,
        uid, emitted-token index), never by engine state, so a request
        samples the same token at a position whatever batch it lands in.
        Also counts live rows whose logits are not all finite."""
        def col(field_of, default, dtype):
            return np.array([default if s is None else field_of(s.req)
                             for s in seqs], dtype)
        live = torch.as_tensor([s is not None for s in seqs],
                               device=rows.device)
        bad = ((~torch.isfinite(rows)).any(dim=-1) & live).sum()
        stok = self.spans.begin("sample")
        toks = sample_stateless(
            self._base_key,
            col(lambda r: r.uid & 0xFFFFFFFF, 0, np.int64),   # probes wrap
            col(lambda r: len(r.out_tokens), 0, np.int64),    # token drawn
            rows, col(lambda r: r.temperature, 0.0, np.float32),
            col(lambda r: r.top_k, 0, np.int64),
            col(lambda r: r.top_p, 1.0, np.float32))
        out = toks.cpu().numpy()
        self.nonfinite_rows += int(bad)
        self.spans.end(stok)
        return out

    # -- prefill ------------------------------------------------------------

    def _prefill_step(self, work: List[Sequence]) -> None:
        stok = self.spans.begin("prefill_step")
        sc = self.sched_cfg
        b, c, m = sc.prefill_batch, sc.prefill_chunk, sc.table_width
        tokens = np.zeros((b, c), np.int64)
        pos = np.zeros((b, c), np.int64)
        qv = np.zeros((b, c), bool)
        tables = np.zeros((b, m), np.int64)
        slots = np.zeros((b,), np.int64)
        last_row = np.zeros((b,), np.int64)
        finishing: List[Optional[Sequence]] = [None] * b
        if self._chunk is not None:
            planned = self._chunk.plan(work, c, b)
        else:
            planned = [(s, min(s.prompt_len - s.prefill_pos, c))
                       for s in work]
        self._c_prefill_tokens.inc(sum(t for _, t in planned))
        for i, (seq, take) in enumerate(planned):
            self._tenant(seq.req)["prefill"].inc(take)
            self.spans.instant("prefill_chunk", uid=seq.req.uid,
                               tokens=take)
            start = seq.prefill_pos
            tr = seq.req.trace
            if tr.count("prefill") == 0:
                tr.stamp("prefill")
            elif self._chunk is not None:
                tr.stamp("chunked_prefill")
            if self.prefix is not None:
                # prefill writes land only in pages this request owns
                # exclusively (shared prefixes are read-only)
                cow.assert_writable(self.sched.alloc, seq.table.pages,
                                    start, take, sc.page_size)
            chunk = np.asarray(seq.req.prompt[start:start + take], np.int64)
            n = len(chunk)
            tokens[i, :n] = chunk
            pos[i] = start + np.arange(c)     # invalid tail masked by q_valid
            qv[i, :n] = True
            tables[i] = seq.table.padded(m)
            slots[i] = seq.slot or 0
            seq.prefill_pos += n
            seq.table.length = seq.prefill_pos
            if seq.prefill_done:
                finishing[i] = seq
                last_row[i] = n - 1
        rows_seqs: List[Optional[Sequence]] = [s for s, _ in planned]
        rows_seqs += [None] * (b - len(rows_seqs))
        logits = self._run_step(tokens, pos, qv, tables, slots, rows_seqs)
        rows = logits[torch.arange(b, device=logits.device),
                      torch.from_numpy(last_row).to(logits.device),
                      : self.cfg.vocab]
        toks = self._sample_rows(rows, finishing)
        now = time.perf_counter()
        for i, seq in enumerate(finishing):
            if seq is None:
                continue
            if self.prefix is not None:
                # cache the prefilled prompt BEFORE a finish frees its
                # pages: the cache's references keep them alive
                self._prefix_insert(seq)
            tok = int(toks[i])
            seq.req.out_tokens.append(tok)
            seq.req.t_first = now
            seq.req.trace.stamp("first_token", now)
            self._c_tokens.inc()
            self._tenant(seq.req)["decode"].inc()
            if tok == seq.req.eos_id or \
                    len(seq.req.out_tokens) >= seq.req.max_new:
                self._finish(seq, now)
        self._flush_cache_copies()
        self._c_prefill_steps.inc()
        stok.args["rows"] = len(planned)
        self.spans.end(stok)

    def _prefix_insert(self, seq: Sequence) -> None:
        """Donate a fully prefilled prompt to the prefix cache. A plan
        with slots attaches the donor's constant-state snapshot, taken
        now (before a decode step moves the slot on), so a later hit
        resumes the SSM exactly at the prompt's end.

        An unaligned prompt's tail page would become shared the moment
        it is cached, and the donor's next decode write would have to
        fork it; so the CACHE takes a private copy of the tail page
        (batched into this prefill step) and the donor keeps its own. If
        no page is free for the copy, the tail is shared as is and the
        scheduler's decode-fork site covers the donor's next write."""
        payload, ptoks = None, 0
        if self.plan.slot_families and seq.slot is not None:
            payload = paged_cache.snapshot_page_rows_async(
                self.pools, [], [seq.slot])
            self._pending_snaps.append(payload)
            ptoks = seq.prompt_len
        pages = list(seq.table.pages)
        tail_src, cp = None, None
        if seq.prompt_len % self.sched_cfg.page_size:
            got = self.sched.alloc.alloc(1)
            if got is not None:
                tail_src, cp = pages[-1], got[0]
                pages[-1] = cp
        newly = self.prefix.insert(seq.ns, seq.req.prompt, pages, payload,
                                   payload_tokens=ptoks)
        if cp is not None:
            if cp in newly:
                # the alloc ref on cp is held until the flush, so the page
                # cannot be recycled into another copy's destination first
                self._cache_copies.append((tail_src, cp))
            else:                       # tail node existed: copy unused
                self.sched.alloc.free([cp])
                self.sched._sync_gauges()

    def _flush_cache_copies(self) -> None:
        """One batched copy for every tail page the cache adopted this
        step, then drop the engine's transient refs (the cache's stay)."""
        if not self._cache_copies:
            return
        paged_cache.copy_page_rows(self.pools,
                                   [s for s, _ in self._cache_copies],
                                   [d for _, d in self._cache_copies])
        self._c_cow_forks.inc(len(self._cache_copies))
        self.spans.instant("cache_tail_copy", pages=len(self._cache_copies))
        self.sched.alloc.free([d for _, d in self._cache_copies])
        self._cache_copies.clear()
        self.sched._sync_gauges()

    # -- completion ----------------------------------------------------------

    def _finish(self, seq: Sequence, now: float) -> None:
        req = seq.req
        req.done = True
        req.finish_reason = ("eos" if req.out_tokens
                             and req.out_tokens[-1] == req.eos_id
                             else "length")
        req.t_done = now
        tr = req.trace
        tr.stamp("done", now)
        for hist, value in ((self._h_queue, tr.queue_time),
                            (self._h_ttft, tr.ttft), (self._h_e2e, tr.e2e),
                            (self._h_tpot, tr.tpot(len(req.out_tokens)))):
            if value is not None:
                hist.observe(value)
        self._c_requests.inc()
        self._tenant(req)["requests"].inc()
        self.metrics.event("done", uid=req.uid, engine=self.engine_id,
                           tokens=len(req.out_tokens))
        self.sched.finished(seq)

    # -- decode -------------------------------------------------------------

    def _evict(self, victim: Sequence) -> None:
        if victim.fork is not None:
            # a decode fork planned earlier in this grow loop: the table
            # already points at the not-yet-copied destination, so the
            # copy must land before the snapshot reads it
            self._apply_forks([victim])
        snap = paged_cache.snapshot_page_rows_async(
            self.pools, victim.table.pages, self._slot_ids(victim))
        self._pending_snaps.append(snap)
        self.sched.evicted(victim, snap)
        self.spans.instant("preempt", uid=victim.req.uid)
        victim.req.trace.stamp("preempted")
        self.metrics.event("preempted", uid=victim.req.uid,
                           engine=self.engine_id)
        self._c_preemptions.inc()

    def _decode_step(self, ready: List[Sequence]) -> bool:
        stok = self.spans.begin("decode_step")
        try:
            return self._decode_once(ready, stok)
        finally:
            self.spans.end(stok)

    def _decode_once(self, ready: List[Sequence], stok) -> bool:
        sc = self.sched_cfg
        batch: List[Sequence] = []
        for seq in ready:
            if seq not in self.sched.running:
                continue                       # evicted below us this step
            ok, victim = self.sched.grow_for_decode(seq)
            while not ok and victim is not None:
                self._evict(victim)
                batch = [s for s in batch if s is not victim]
                ok, victim = self.sched.grow_for_decode(seq)
            if ok:
                batch.append(seq)
        if not batch:
            return False
        self._apply_forks(batch)         # COW: writes into shared pages
        #                                  fork first
        b, m = sc.max_batch, sc.table_width
        tokens = np.zeros((b, 1), np.int64)
        pos = np.zeros((b, 1), np.int64)
        qv = np.zeros((b, 1), bool)
        tables = np.zeros((b, m), np.int64)
        slots = np.zeros((b,), np.int64)
        for i, seq in enumerate(batch):
            if self.prefix is not None:
                cow.assert_writable(self.sched.alloc, seq.table.pages,
                                    seq.table.length, 1, sc.page_size)
            tokens[i, 0] = seq.req.out_tokens[-1]
            pos[i, 0] = seq.table.length
            qv[i, 0] = True
            tables[i] = seq.table.padded(m)
            slots[i] = seq.slot or 0
        padded = batch + [None] * (b - len(batch))
        logits = self._run_step(tokens, pos, qv, tables, slots, padded)
        rows = logits[:, 0, : self.cfg.vocab]
        toks = self._sample_rows(rows, padded)
        now = time.perf_counter()
        for i, seq in enumerate(batch):
            seq.table.length += 1
            tok = int(toks[i])
            seq.req.out_tokens.append(tok)
            if seq.req.trace.count("decode") == 0:
                seq.req.trace.stamp("decode", now)
            self._c_tokens.inc()
            self._tenant(seq.req)["decode"].inc()
            if tok == seq.req.eos_id or \
                    len(seq.req.out_tokens) >= seq.req.max_new:
                self._finish(seq, now)
        self._c_decode_steps.inc()
        stok.args["rows"] = len(batch)
        self._maybe_sample_quality()
        return True

    def defrag(self) -> None:
        """Compact live pages to the low pool indices (an idle-time
        locality step; paging never needs it for correctness)."""
        moves = self.sched.defrag()
        paged_cache.apply_moves(self.pools, moves)

    # -- introspection ------------------------------------------------------

    @property
    def free_pages(self) -> int:
        return self.sched.alloc.free_pages

    @property
    def free_slots(self) -> int:
        return self.sched.free_slots

    @property
    def usable_pages(self) -> int:
        """Paged-domain pages available to requests (page 0 is null)."""
        return max(self.sched_cfg.num_pages - 1, 1)

    @property
    def usable_slots(self) -> int:
        """Slot-domain slots available to requests (slot 0 is null)."""
        return max(self.sched.num_slots - 1, 1)

    @property
    def free_fraction(self) -> float:
        """Fraction of the binding pool currently free (the router's
        pressure signal): the minimum over the domains the plan
        allocates from."""
        fr = []
        if self.plan.has_paged:
            fr.append(self.free_pages / self.usable_pages)
        if self.sched.slot_alloc is not None:
            fr.append(self.free_slots / self.usable_slots)
        return min(fr) if fr else 1.0

    def cache_report(self, max_len: Optional[int] = None) -> Dict:
        ml = max_len or (self.sched_cfg.table_width * self.sched_cfg.page_size)
        return {"family": self.plan.name,
                "bytes_per_token_per_layer":
                    self.plan.bytes_per_token(self.cfg, ml, self.paged),
                "pool_bytes": paged_cache.pool_bytes(self.pools),
                "pool_bytes_per_device":
                    paged_cache.pool_bytes_per_device(self.pools),
                "free_pages": self.sched.alloc.free_pages,
                "free_slots": self.sched.free_slots}
