"""Paged continuous-batching serving engine (SRF family).

Port of ``repro.serving.engine``: requests share pooled, pre-allocated
SRF states (``paged_cache``), one constant-size slot per request; the
scheduler (a copy of the reference's) handles admission, chunked
prefill and preemption; prefill and decode both run as batched
``transformer.paged_step`` calls with fixed shapes (prefill_batch x
chunk, max_batch x 1), inactive rows masked onto the null slot 0.
Sampling is greedy.

Not ported in this slice, and refused if asked for: the prefix cache,
live quality probes, mesh-sharded pools, per-request projection seeds,
enc-dec memories and sampled (temperature > 0) decoding.
"""
from __future__ import annotations

import itertools
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.models import attention as attn_lib
from repro_torch.models import transformer as model_lib
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import trace as obs_trace

from . import paged_cache
from .sampler import sample_greedy
from .scheduler import SchedConfig, Scheduler, Sequence


@dataclass
class Request:
    uid: int
    prompt: np.ndarray               # (P,) int32
    max_new: int = 32
    eos_id: int = -1                 # -1: never
    priority: int = 0                # higher first (policy="priority")
    temperature: float = 0.0         # 0 = greedy (the only ported mode)
    top_k: int = 0
    top_p: float = 1.0
    embed_seed: int = 0              # seeded-SRF personalization (not ported)
    enc_emb: Optional[np.ndarray] = None  # enc-dec input (not ported)
    deadline: Optional[float] = None # seconds after submit; overdue WAITING
    #                                  requests finish as 'timeout'
    namespace: str = ""              # tenant id
    out_tokens: List[int] = field(default_factory=list)
    done: bool = False
    finish_reason: str = ""          # eos | length | timeout
    deadline_at: Optional[float] = None
    t_submit: float = 0.0            # perf_counter stamps
    t_first: float = 0.0
    t_done: float = 0.0
    trace: Optional[obs_trace.Trace] = None


def _default_sched(cfg, batch_slots: int, max_len: int, plan,
                   policy: str) -> SchedConfig:
    """The reference's default geometry (constant-state plans: the slot
    domain is the whole geometry)."""
    page = 16 if max_len >= 64 else 8
    return SchedConfig(max_batch=batch_slots, prefill_batch=batch_slots,
                       prefill_chunk=min(32, max(8, page)), page_size=page,
                       num_pages=2, table_width=1,
                       num_slots=batch_slots + 1, policy=policy)


_ENGINE_IDS = itertools.count()


class Engine:
    """Continuous batching over the pooled SRF states on ``device``."""

    def __init__(self, cfg, params, batch_slots: int = 4,
                 max_len: int = 512, sched: Optional[SchedConfig] = None,
                 policy: str = "fcfs",
                 metrics: Optional[obs_metrics.MetricsRegistry] = None,
                 device="cuda", mesh=None, prefix=None,
                 quality_every: int = 0):
        for name, asked in (("mesh-sharded serving", mesh is not None),
                            ("the prefix cache", prefix is not None),
                            ("live quality probes", quality_every)):
            if asked:
                raise NotImplementedError(f"{name} is "
                                          f"{attn_lib.NOT_IN_SLICE}")
        self.cfg = cfg
        self.device = torch.device(device)
        self.plan = paged_cache.plan_for(cfg)
        self.metrics = metrics if metrics is not None \
            else obs_metrics.MetricsRegistry()
        self.engine_id = str(next(_ENGINE_IDS))
        if sched is None:
            sched = _default_sched(cfg, batch_slots, max_len, self.plan,
                                   policy)
        self.sched_cfg = sched
        self.sched = Scheduler(sched, self.plan, metrics=self.metrics,
                               labels={"engine": self.engine_id})
        self.pools = paged_cache.init_pools(cfg, sched.num_pages,
                                            sched.page_size,
                                            num_slots=self.sched.num_slots,
                                            device=self.device)
        self.params = params
        self.clock = time.perf_counter
        self.nonfinite_rows = 0          # sampled logit rows with inf/nan
        self._init_metrics()

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
        self._h_step = h("engine_step_seconds", "wall time of one engine "
                         "step")
        self._h_ttft = h("request_ttft_seconds", "time to first token")
        self._h_tpot = h("request_tpot_seconds", "per-output-token time "
                         "after the first")
        self._h_queue = h("request_queue_seconds", "submit -> admission")
        self._h_e2e = h("request_e2e_seconds", "submit -> done")
        self.stats = obs_metrics.StatsView({
            "tokens": self._c_tokens.value,
            "requests": self._c_requests.value,
            "prefill_steps": self._c_prefill_steps.value,
            "decode_steps": self._c_decode_steps.value,
            "preemptions": self._c_preemptions.value,
        })

    # -- public API ---------------------------------------------------------

    def submit(self, req: Request) -> None:
        if req.enc_emb is not None:
            raise NotImplementedError(f"enc-dec serving is "
                                      f"{attn_lib.NOT_IN_SLICE}")
        if req.embed_seed:
            from repro_torch.core.spinner import SEEDED_NOT_PORTED
            raise NotImplementedError(SEEDED_NOT_PORTED)
        if req.temperature > 0:
            from .sampler import SAMPLING_NOT_PORTED
            raise NotImplementedError(SAMPLING_NOT_PORTED)
        now = time.perf_counter()
        req.t_submit = now
        if req.deadline is not None and req.deadline_at is None:
            req.deadline_at = now + req.deadline
        if req.trace is None:
            req.trace = obs_trace.Trace(uid=req.uid)
        req.trace.stamp("queued", now)
        self.sched.submit(req)

    def run(self) -> List[Request]:
        """Drain all submitted requests; returns the completed ones."""
        tracked = [s.req for s in self.sched.waiting + self.sched.running]
        stall = 0
        while self.sched.has_work:
            progressed = self.step()
            stall = 0 if progressed else stall + 1
            if stall > 2:
                raise RuntimeError(
                    "scheduler stalled: pool too small for the remaining "
                    f"requests ({self.sched.free_slots} free slots)")
        return [r for r in tracked if r.done]

    def step(self) -> bool:
        """One scheduler iteration: admit, then one prefill-chunk step if
        any sequence is still prefilling, else one batched decode step.
        Returns False when nothing could run."""
        t0 = self.clock()
        try:
            return self._step_once()
        finally:
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
                paged_cache.restore_slot_rows(self.pools, [seq.slot],
                                              seq.snapshot)
                self.sched.restored(seq)
                seq.req.trace.stamp("restored", now)
            elif seq.slot is not None:
                fresh.append(seq)        # a reused slot starts from zero
        if fresh:
            paged_cache.zero_slot_rows(self.pools, [s.slot for s in fresh])
        work = self.sched.prefill_work()
        if work:
            self._prefill_step(work)
            return True
        ready = self.sched.decode_ready()
        if ready:
            return self._decode_step(ready) or bool(expired)
        return bool(admitted) or bool(expired)

    def _expire(self, seq: Sequence) -> None:
        req = seq.req
        req.done = True
        req.finish_reason = "timeout"
        req.t_done = time.perf_counter()
        req.trace.stamp("done", req.t_done)
        if req.trace.e2e is not None:
            self._h_e2e.observe(req.trace.e2e)
        self._c_expired.inc()

    # -- device step ---------------------------------------------------------

    def _run_step(self, tokens, pos, qv, tables, slots) -> torch.Tensor:
        dev = self.device
        logits, self.pools = model_lib.paged_step(
            self.params, self.cfg, self.pools,
            torch.from_numpy(tokens).to(dev), torch.from_numpy(pos).to(dev),
            torch.from_numpy(qv).to(dev), torch.from_numpy(tables).to(dev),
            torch.from_numpy(slots).to(dev))
        return logits

    def _sample_rows(self, rows: torch.Tensor,
                     seqs: List[Optional[Sequence]]) -> np.ndarray:
        """Greedy tokens for the rows of ``seqs`` (None = padded row);
        also counts live rows whose logits are not all finite."""
        temps = np.array([0.0 if s is None else s.req.temperature
                          for s in seqs], np.float32)
        live = torch.as_tensor([s is not None for s in seqs],
                               device=rows.device)
        bad = ((~torch.isfinite(rows)).any(dim=-1) & live).sum()
        toks = sample_greedy(rows, temps)
        out = toks.cpu().numpy()
        self.nonfinite_rows += int(bad)
        return out

    # -- prefill ------------------------------------------------------------

    def _prefill_step(self, work: List[Sequence]) -> None:
        sc = self.sched_cfg
        b, c, m = sc.prefill_batch, sc.prefill_chunk, sc.table_width
        tokens = np.zeros((b, c), np.int64)
        pos = np.zeros((b, c), np.int64)
        qv = np.zeros((b, c), bool)
        tables = np.zeros((b, m), np.int64)
        slots = np.zeros((b,), np.int64)
        last_row = np.zeros((b,), np.int64)
        finishing: List[Optional[Sequence]] = [None] * b
        planned = [(s, min(s.prompt_len - s.prefill_pos, c)) for s in work]
        self._c_prefill_tokens.inc(sum(t for _, t in planned))
        for i, (seq, take) in enumerate(planned):
            start = seq.prefill_pos
            if seq.req.trace.count("prefill") == 0:
                seq.req.trace.stamp("prefill")
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
        logits = self._run_step(tokens, pos, qv, tables, slots)
        rows = logits[torch.arange(b, device=logits.device),
                      torch.from_numpy(last_row).to(logits.device),
                      : self.cfg.vocab]
        toks = self._sample_rows(rows, finishing)
        now = time.perf_counter()
        for i, seq in enumerate(finishing):
            if seq is None:
                continue
            tok = int(toks[i])
            seq.req.out_tokens.append(tok)
            seq.req.t_first = now
            seq.req.trace.stamp("first_token", now)
            self._c_tokens.inc()
            if tok == seq.req.eos_id or \
                    len(seq.req.out_tokens) >= seq.req.max_new:
                self._finish(seq, now)
        self._c_prefill_steps.inc()

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
        self.sched.finished(seq)

    # -- decode -------------------------------------------------------------

    def _evict(self, victim: Sequence) -> None:
        snap = paged_cache.snapshot_slot_rows(self.pools, [victim.slot])
        self.sched.evicted(victim, snap)
        victim.req.trace.stamp("preempted")
        self._c_preemptions.inc()

    def _decode_step(self, ready: List[Sequence]) -> bool:
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
        b, m = sc.max_batch, sc.table_width
        tokens = np.zeros((b, 1), np.int64)
        pos = np.zeros((b, 1), np.int64)
        qv = np.zeros((b, 1), bool)
        tables = np.zeros((b, m), np.int64)
        slots = np.zeros((b,), np.int64)
        for i, seq in enumerate(batch):
            tokens[i, 0] = seq.req.out_tokens[-1]
            pos[i, 0] = seq.table.length
            qv[i, 0] = True
            tables[i] = seq.table.padded(m)
            slots[i] = seq.slot or 0
        logits = self._run_step(tokens, pos, qv, tables, slots)
        rows = logits[:, 0, : self.cfg.vocab]
        toks = self._sample_rows(rows, batch + [None] * (b - len(batch)))
        now = time.perf_counter()
        for i, seq in enumerate(batch):
            seq.table.length += 1
            tok = int(toks[i])
            seq.req.out_tokens.append(tok)
            if seq.req.trace.count("decode") == 0:
                seq.req.trace.stamp("decode", now)
            self._c_tokens.inc()
            if tok == seq.req.eos_id or \
                    len(seq.req.out_tokens) >= seq.req.max_new:
                self._finish(seq, now)
        self._c_decode_steps.inc()
        return True

    # -- introspection ------------------------------------------------------

    @property
    def free_slots(self) -> int:
        return self.sched.free_slots

    @property
    def usable_slots(self) -> int:
        """Slot-domain slots available to requests (slot 0 is null)."""
        return max(self.sched.num_slots - 1, 1)

    def cache_report(self, max_len: Optional[int] = None) -> Dict:
        ml = max_len or (self.sched_cfg.table_width * self.sched_cfg.page_size)
        return {"family": self.plan.name,
                "bytes_per_token_per_layer":
                    self.plan.bytes_per_token(self.cfg, ml),
                "pool_bytes": paged_cache.pool_bytes(self.pools),
                "free_slots": self.sched.free_slots}
