"""Fault-tolerant serving: replica health detection and request rescue
primitives.

Port of ``repro.serving.ft``. Request state is cheap to rebuild, so the
death of a replica never has to lose work. Snapshots and prefill
progress travel between replicas (``Scheduler.release_waiting`` /
``adopt``), and anything without a current snapshot is *replayed*: the
tokens already emitted are folded into the prompt as a forced prefix
(:func:`fold_emitted_prefix`), so a survivor re-prefills and continues
exactly where the dead replica stopped. Exactly-once output rests on
the request uid and the emitted-token high-water mark: ``out_tokens``
is never truncated, and the engine only appends past it.

:class:`ReplicaWatchdog` adapts ``ft/straggler.py``'s EMA-against-median
detector to serving replicas, with two changes:

* step times are read from the metrics registry
  (``engine_step_seconds{engine=...}``), not timed by the caller, so a
  stall injected through the engine's step-time clock
  (``serving/chaos.py``) is detected exactly like a real one;
* each replica's EMA is compared with the median of its *peers* (the
  global median breaks down at 2 replicas: the slow replica is the
  upper median and never exceeds ``threshold`` times itself).

A replica is marked dead after ``grace_steps`` consecutive slow flags,
after ``stuck_rounds`` consecutive rounds without progress while it
holds work, or when an exception escapes ``Engine.step`` (the router
handles that case itself). ``serving/mesh/router.py`` owns quarantine,
rescue and revive; this module owns detection and the replay
arithmetic. All of it is host-side: no device traffic.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Set, Tuple

import numpy as np

from repro_torch.models import frontends
from repro_torch.obs import spans as obs_spans

from .engine import Request


@dataclass(frozen=True)
class FTConfig:
    """Knobs of the fault-tolerant router (``Router(ft=FTConfig())``)."""
    ema: float = 0.6            # smoothing of a replica's step time
    threshold: float = 4.0      # x peer-median EMA -> slow flag
    grace_steps: int = 3        # consecutive slow flags before quarantine
    stuck_rounds: int = 4       # rounds without progress, with work
    probe_max_new: int = 2      # tokens a revive() probe must produce
    degraded_rounds: int = 3    # exhausted rounds before shedding new load


class ReplicaWatchdog:
    """Per-replica health detector driven by the shared metrics registry.

    The router calls :meth:`poll_step_time` and :meth:`observe` once per
    replica and drive round; a return value other than ``None`` is the
    reason to quarantine. Pure host-side arithmetic, no timers of its
    own."""

    def __init__(self, n_replicas: int, cfg: FTConfig, spans=None):
        self.cfg = cfg
        self.spans = spans if spans is not None else obs_spans.NOOP
        self.ema: List[Optional[float]] = [None] * n_replicas
        self.flags: List[int] = [0] * n_replicas
        self.stuck: List[int] = [0] * n_replicas
        self.dead: Set[int] = set()
        # (count, sum) watermark per replica into engine_step_seconds
        self._seen: List[Tuple[int, float]] = [(0, 0.0)] * n_replicas

    def poll_step_time(self, idx: int, engine) -> Optional[float]:
        """Mean of the step times the engine recorded since the last
        poll, read from its registry (replicas may share one: the
        ``engine`` label keeps the series apart). ``None`` when the
        registry is disabled or nothing new landed."""
        h = engine.metrics.histogram(
            "engine_step_seconds", "wall time of one engine step",
            ("engine",)).labels(engine=engine.engine_id)
        c, s = h.count(), h.sum()
        c0, s0 = self._seen[idx]
        self._seen[idx] = (c, s)
        if c <= c0:
            return None
        return (s - s0) / (c - c0)

    def _peer_median(self, idx: int) -> Optional[float]:
        """Median EMA over the other live replicas."""
        ts = sorted(e for i, e in enumerate(self.ema)
                    if i != idx and i not in self.dead and e is not None)
        if not ts:
            return None
        return ts[len(ts) // 2]

    def observe(self, idx: int, dt: Optional[float], progressed: bool,
                has_work: bool) -> Optional[str]:
        """Feed one drive round's outcome for replica ``idx``; returns a
        reason to quarantine, or ``None``."""
        if idx in self.dead:
            return None
        cfg = self.cfg
        # stuck: the replica holds work it cannot advance (corrupt
        # admission, exhausted pool); the step-time EMA never sees it,
        # because the steps that do nothing are fast
        if has_work and not progressed:
            self.stuck[idx] += 1
            self.spans.instant("watchdog_flag", replica_idx=idx,
                               flag="stuck", rounds=self.stuck[idx])
            if self.stuck[idx] >= cfg.stuck_rounds:
                return (f"stuck: no progress for {self.stuck[idx]} "
                        "consecutive rounds with work queued")
        else:
            self.stuck[idx] = 0
        if dt is not None:
            prev = self.ema[idx]
            self.ema[idx] = dt if prev is None \
                else cfg.ema * prev + (1 - cfg.ema) * dt
            med = self._peer_median(idx)
            if med is not None and self.ema[idx] > cfg.threshold * med:
                self.flags[idx] += 1
                self.spans.instant("watchdog_flag", replica_idx=idx,
                                   flag="slow", rounds=self.flags[idx])
                if self.flags[idx] >= cfg.grace_steps:
                    return (f"slow: step-time ema {self.ema[idx]:.4g}s > "
                            f"{cfg.threshold}x peer median {med:.4g}s for "
                            f"{self.flags[idx]} consecutive polls")
            else:
                self.flags[idx] = 0
        return None

    def mark_dead(self, idx: int) -> None:
        self.dead.add(idx)

    def revive(self, idx: int) -> None:
        """Clear the replica's health history, so that its EMA from
        before its death does not flag it again at once."""
        self.dead.discard(idx)
        self.ema[idx] = None
        self.flags[idx] = 0
        self.stuck[idx] = 0


# ---------------------------------------------------------------------------
# rescue primitives
# ---------------------------------------------------------------------------

def snapshot_is_current(seq) -> bool:
    """Whether a sequence's copy-on-preempt snapshot still holds its
    whole progress: true exactly for sequences evicted and still waiting
    (nothing decodes while waiting). A running sequence's device state
    is ahead of any old snapshot, so it is replayed instead."""
    return seq.snapshot is not None


def fold_emitted_prefix(req: Request) -> int:
    """Fold the emitted tokens into the prompt as a forced prefix, so a
    rescued request re-prefills on a survivor and greedy decode goes on
    from where the dead replica stopped. Returns the emitted-token
    high-water mark.

    ``out_tokens`` is not cleared: the engine appends after the
    high-water mark (``len(out_tokens) >= max_new`` ends the request on
    the same total), so every token is emitted exactly once; a replay
    only recomputes the prefix's cache state."""
    hwm = len(req.out_tokens)
    if hwm:
        prompt = np.asarray(req.prompt)
        req.prompt = np.concatenate(
            [prompt, np.asarray(req.out_tokens, dtype=prompt.dtype)])
    return hwm


def make_probe(cfg, uid: int = -1, max_new: int = 2) -> Request:
    """A tiny greedy request with which ``Router.revive`` proves that a
    quarantined replica is healthy again before it rejoins placement;
    an enc-dec probe carries synthetic audio features drawn from
    ``default_rng(0)``, the reference's."""
    prompt = (np.arange(1, 4, dtype=np.int32) % cfg.vocab).astype(np.int32)
    enc = None
    if cfg.is_encdec:
        enc = frontends.synthetic_audio_features(np.random.default_rng(0),
                                                 cfg)
    return Request(uid=uid, prompt=prompt, max_new=max_new, enc_emb=enc)
