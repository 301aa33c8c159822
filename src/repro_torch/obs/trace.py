"""Per-request lifecycle traces and latency aggregation.

A :class:`Trace` is an append-only list of ``(event, t)`` stamps taken
with ``time.perf_counter()`` (monotonic — wall-clock ``time.time()``
steps corrupt TTFT/TPOT, which is why the engines stamp perf_counter
everywhere). The canonical lifecycle is

    queued -> admitted [-> prefix_hit] -> prefill [-> chunked_prefill...]
           -> first_token -> decode -> done

with ``preempted`` / ``restored`` / ``migrated`` free to interleave
(possibly repeatedly) between ``admitted`` and ``done``. ``prefix_hit``
marks a fresh admission that attached cached prefix pages (stamped once,
right after ``admitted``); ``chunked_prefill`` marks every prefill
continuation chunk under a chunk policy (repeatable, but its FIRST
occurrence still sits between ``prefill`` and ``first_token``). Derived
latencies:

    queue_time = first admitted - queued       (admission wait)
    ttft       = first_token    - queued       (time to first token)
    tpot       = (done - first_token) / (n_tokens - 1)
    e2e        = done           - queued

``latency_summary`` folds a batch of finished requests into
p50/p95/p99 percentiles of each — the numbers SLO-aware scheduling and
the serving bench report.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

# lifecycle order used by monotonicity checks. ``prefix_hit`` and
# ``chunked_prefill`` are optional milestones (prefix-sharing subsystem);
# ``chunked_prefill`` repeats per continuation chunk, but like ``decode``
# its first occurrence is still pinned in canonical order.
LIFECYCLE = ("queued", "admitted", "prefix_hit", "prefill",
             "chunked_prefill", "first_token", "decode", "done")


@dataclass
class Trace:
    """Append-only event stamps for one request."""
    uid: int = -1
    events: List[Tuple[str, float]] = field(default_factory=list)

    def stamp(self, name: str, t: Optional[float] = None) -> float:
        t = time.perf_counter() if t is None else t
        self.events.append((name, t))
        return t

    def first(self, name: str) -> Optional[float]:
        for n, t in self.events:
            if n == name:
                return t
        return None

    def last(self, name: str) -> Optional[float]:
        for n, t in reversed(self.events):
            if n == name:
                return t
        return None

    def count(self, name: str) -> int:
        return sum(1 for n, _ in self.events if n == name)

    # -- derived latencies ---------------------------------------------------

    def _delta(self, a: str, b: str) -> Optional[float]:
        ta, tb = self.first(a), self.first(b)
        return None if ta is None or tb is None else tb - ta

    @property
    def queue_time(self) -> Optional[float]:
        return self._delta("queued", "admitted")

    @property
    def ttft(self) -> Optional[float]:
        return self._delta("queued", "first_token")

    @property
    def e2e(self) -> Optional[float]:
        return self._delta("queued", "done")

    def tpot(self, n_tokens: int) -> Optional[float]:
        d = self._delta("first_token", "done")
        if d is None or n_tokens <= 1:
            return None
        return d / (n_tokens - 1)

    # -- validation ----------------------------------------------------------

    def monotonic(self) -> bool:
        """All stamps non-decreasing in arrival order AND the lifecycle
        milestones (first occurrence each) appear in canonical order —
        checked by event POSITION, not just time, so two milestones
        stamped in the same instant still must arrive in order."""
        times = [t for _, t in self.events]
        if any(b < a for a, b in zip(times, times[1:])):
            return False
        pos = {}
        for i, (n, _) in enumerate(self.events):
            pos.setdefault(n, i)
        idx = [pos[n] for n in LIFECYCLE if n in pos]
        return all(b > a for a, b in zip(idx, idx[1:]))


# ---------------------------------------------------------------------------
# aggregation
# ---------------------------------------------------------------------------

def percentiles(values: Iterable[float],
                qs: Sequence[float] = (50, 95, 99)) -> Dict[str, float]:
    """{'p50': ..., 'p95': ...} via nearest-rank on the sorted sample;
    NaNs for an empty sample (the caller prints/serializes them as-is)."""
    srt = sorted(values)
    out: Dict[str, float] = {}
    for q in qs:
        key = f"p{q:g}"
        if not srt:
            out[key] = float("nan")
        else:
            idx = min(len(srt) - 1, max(0, round(q / 100.0 * (len(srt) - 1))))
            out[key] = srt[idx]
    return out


def latency_summary(requests, qs: Sequence[float] = (50, 95, 99)) -> Dict:
    """Percentile summary over finished requests (uses traces when
    present, the ``t_submit``/``t_first``/``t_done`` stamps otherwise).
    All values in seconds."""
    ttft, tpot, queue, e2e = [], [], [], []
    n_tokens = 0
    for r in requests:
        if not getattr(r, "done", False):
            continue
        n = len(getattr(r, "out_tokens", ()) or ())
        n_tokens += n
        tr = getattr(r, "trace", None)
        if tr is not None and tr.first("done") is not None:
            if tr.ttft is not None:
                ttft.append(tr.ttft)
            tp = tr.tpot(n)
            if tp is not None:
                tpot.append(tp)
            if tr.queue_time is not None:
                queue.append(tr.queue_time)
            if tr.e2e is not None:
                e2e.append(tr.e2e)
        else:
            ttft.append(r.t_first - r.t_submit)
            if n > 1:
                tpot.append((r.t_done - r.t_first) / (n - 1))
            e2e.append(r.t_done - r.t_submit)
    return {"requests": len(ttft), "tokens": n_tokens,
            "ttft_s": percentiles(ttft, qs),
            "tpot_s": percentiles(tpot, qs),
            "queue_s": percentiles(queue, qs),
            "e2e_s": percentiles(e2e, qs)}
