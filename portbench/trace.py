"""The device trace of a ``--trace 1`` run, reduced: every device
operation as (name, start, end) and every host operation likewise,
from ``torch.profiler`` (CUPTI) over the measured window; then the
device's busy seconds (the union of its operations' intervals), its
time by operation name, and its idle gaps by what the host was doing.

The arithmetic (a union of kernel intervals, sums by name) is that of
the port's ``launch/profile_serve.py`` and ``profile_train.py``, copied
here so that the yardstick does not move with the program."""
from __future__ import annotations

import bisect
from collections import defaultdict
from typing import Dict, List, Tuple

from portbench.bench import union_seconds

Event = Tuple[str, float, float]         # name, start s, end s
NO_OP = "host: no operation open"
NAME_CHARS = 160                         # a breakdown row's name, cut


def _ns(evt, which: str) -> float:
    for name, mul in ((f"{which}_ns", 1.0), (f"{which}_us", 1e3)):
        fn = getattr(evt, name, None)
        if fn is not None:
            return float(fn()) * mul
    raise AttributeError(f"profiler event has no {which}_ns")


def events(prof) -> Tuple[List[Event], List[Event]]:
    """(device operations, host events) of a finished profiler, in
    seconds on the profiler's clock. A host range (``record_function``)
    is also drawn on the device's timeline from its first kernel to its
    last; such rows carry a host event's name and are no operation."""
    import torch
    cuda = torch.autograd.DeviceType.CUDA
    dev: List[Event] = []
    host: List[Event] = []
    for e in prof.profiler.kineto_results.events():
        t0 = _ns(e, "start") * 1e-9
        t1 = t0 + _ns(e, "duration") * 1e-9
        (dev if e.device_type() == cuda else host).append(
            (e.name(), t0, t1))
    ranges = {name for name, _, _ in host}
    return [d for d in dev if d[0] not in ranges], host


def by_name(dev: List[Event]) -> Dict[str, float]:
    """Device seconds by operation name."""
    out: Dict[str, float] = defaultdict(float)
    for name, a, b in dev:
        out[name] += b - a
    return dict(out)


def gaps(dev: List[Event]) -> List[Tuple[float, float]]:
    """The idle intervals between the device's busy intervals, from its
    first operation's start to its last one's end."""
    out, end = [], None
    for a, b in sorted((a, b) for _, a, b in dev):
        if end is not None and a > end:
            out.append((end, a))
        end = b if end is None else max(end, b)
    return out


def idle_by_host(dev: List[Event], host: List[Event]) -> Dict[str, float]:
    """Idle device seconds by the innermost host operation open at the
    middle of each gap (``NO_OP`` where none is)."""
    host = sorted(host, key=lambda e: e[1])
    starts = [e[1] for e in host]
    out: Dict[str, float] = defaultdict(float)
    for a, b in gaps(dev):
        mid = 0.5 * (a + b)
        best = None
        i = bisect.bisect_right(starts, mid)
        # scan back over host events that started before the middle; the
        # innermost open one is the latest-starting that still covers it
        for name, s, e in reversed(host[max(0, i - 256):i]):
            if e >= mid:
                best = name
                break
        out[best or NO_OP] += b - a
    return dict(out)


def reduce(dev: List[Event], host: List[Event], window_s: float) -> Dict:
    """What a traced run reports: busy seconds, the window, and the ten
    largest rows of device time by name and of idle time by host
    operation."""
    def top(d):
        return [[k[:NAME_CHARS], v] for k, v in
                sorted(d.items(), key=lambda kv: -kv[1])[:10]]
    return {"busy_s": union_seconds([(a, b) for _, a, b in dev]),
            "window_s": window_s,
            "device_ops": top(by_name(dev)),
            "idle_gaps": top(idle_by_host(dev, host))}
