"""Chrome-trace-event export for span timelines.

Port of ``repro.obs.export``: plain Python, giving the reference's
events on the same span records. ``chrome_trace`` turns one or more
:class:`~repro_torch.obs.spans.SpanRecorder` rings into the Trace Event JSON format that chrome://tracing and
Perfetto load directly: duration spans as paired ``B``/``E`` events,
instants as ``i`` events, one *process* row per replica (``pid`` =
replica id), with ``process_name`` metadata so the UI labels rows
``replica 0``, ``replica 1``, ...

All recorders in a deployment share the ``time.perf_counter`` epoch, so
merging is just concatenation; timestamps are normalized to the global
minimum and emitted in microseconds (the format's unit), putting every
replica on one clock axis.

Begin/end pairs must nest properly per (pid, tid). Spans from a single
recorder nest by construction (stack discipline), so the emitter sorts
each process's spans by start time and replays them through an explicit
stack, closing any span that ends before the next one starts — the
resulting event stream is monotone in ``ts`` and properly paired, which
is exactly what the golden test pins.
"""
from __future__ import annotations

import json
from typing import Any, Dict, List

from .spans import Span, SpanRecorder

__all__ = ["chrome_trace", "dump_chrome_trace"]


def _collect(source) -> List[Span]:
    """Accept a recorder, an iterable of recorders, or an iterable of
    Span records (mixing is fine)."""
    if isinstance(source, SpanRecorder):
        return source.snapshot()
    out: List[Span] = []
    for item in source:
        if isinstance(item, SpanRecorder):
            out.extend(item.snapshot())
        else:
            out.append(item)
    return out


def _args(rec: Span) -> Dict[str, Any]:
    a = dict(rec.args)
    if rec.uid is not None:
        a["uid"] = rec.uid
    return a


def chrome_trace(source) -> Dict[str, Any]:
    """Build a Chrome Trace Event JSON object (``{"traceEvents": [...]}``)
    from recorders / span records. Loadable by Perfetto as-is."""
    records = _collect(source)
    events: List[Dict[str, Any]] = []
    if not records:
        return {"traceEvents": [], "displayTimeUnit": "ms"}

    t_zero = min(r.t0 for r in records)
    us = lambda t: round((t - t_zero) * 1e6, 3)  # noqa: E731

    by_pid: Dict[int, List[Span]] = {}
    for r in records:
        by_pid.setdefault(r.replica if r.replica is not None else 0,
                          []).append(r)

    for pid in sorted(by_pid):
        events.append({"name": "process_name", "ph": "M", "pid": pid,
                       "tid": 0, "args": {"name": f"replica {pid}"}})

    for pid in sorted(by_pid):
        group = by_pid[pid]
        spans = sorted((r for r in group if r.kind == "span"),
                       key=lambda r: (r.t0, r.sid))
        stack: List[Span] = []

        def _close(top: Span) -> None:
            events.append({"name": top.name, "ph": "E", "pid": pid,
                           "tid": 0, "ts": us(top.t1)})

        for r in spans:
            while stack and stack[-1].t1 <= r.t0:
                _close(stack.pop())
            events.append({"name": r.name, "ph": "B", "pid": pid, "tid": 0,
                           "ts": us(r.t0), "args": _args(r)})
            stack.append(r)
        while stack:
            _close(stack.pop())

        for r in group:
            if r.kind != "instant":
                continue
            events.append({"name": r.name, "ph": "i", "pid": pid, "tid": 0,
                           "ts": us(r.t0), "s": "t", "args": _args(r)})

    return {"traceEvents": events, "displayTimeUnit": "ms"}


def dump_chrome_trace(path, source) -> int:
    """Write the trace JSON to ``path``; returns the event count."""
    doc = chrome_trace(source)
    with open(path, "w") as fh:
        json.dump(doc, fh)
    return len(doc["traceEvents"])
