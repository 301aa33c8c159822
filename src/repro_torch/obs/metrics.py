"""Labelled metrics registry: Counter / Gauge / Histogram, snapshot +
Prometheus-style text export, and a bounded JSONL event stream.

Design points, in order of importance for the serving hot path:

* **Cheap when enabled.** A bound metric (``metric.labels(...)``) is a
  tiny object holding a direct reference into the parent's value table;
  ``inc`` / ``set`` / ``observe`` are one attribute update each. The
  engine binds its children once at construction, so the per-step cost
  is a handful of float adds — the same work as the ad-hoc ``stats``
  dict writes the registry replaced.
* **Free when disabled.** ``MetricsRegistry(enabled=False)`` hands out
  a shared no-op metric whose mutators do nothing and whose reads
  return zero; no value tables are built, no events are kept.
* **Readable back.** Legacy ``.stats`` dicts survive as
  :class:`StatsView`, a read-only Mapping whose values are computed
  from the live registry on access — nothing is double-counted.

Label values are stringified; each (metric, label-values) pair is one
child. Histograms keep raw observations (bounded ring, default 64k per
child) so percentiles are exact for serving-scale runs; export emits
Prometheus summary-style ``{quantile=...}`` rows. Everything is
single-threaded by design — the serving control plane runs on one
thread, matching the scheduler/engine contract.
"""
from __future__ import annotations

import json
import time
from typing import Callable, Dict, IO, Iterable, List, Mapping, Optional, Tuple

try:                                       # Mapping ABC for StatsView
    from collections.abc import Mapping as _MappingABC
except ImportError:                        # pragma: no cover
    _MappingABC = object


# ---------------------------------------------------------------------------
# no-op metric (disabled registries hand this out)
# ---------------------------------------------------------------------------

class _NoopMetric:
    """Answers the full Counter/Gauge/Histogram surface with nothing."""

    def labels(self, **_kw):
        return self

    def inc(self, amount=1, **_kw):
        pass

    def dec(self, amount=1, **_kw):
        pass

    def set(self, value, **_kw):
        pass

    def observe(self, value, **_kw):
        pass

    def value(self, **_kw):
        return 0

    def count(self, **_kw):
        return 0

    def sum(self, **_kw):
        return 0.0

    def percentile(self, q, **_kw):
        return float("nan")

    def all_values(self):
        return []


NOOP = _NoopMetric()


# ---------------------------------------------------------------------------
# live metrics
# ---------------------------------------------------------------------------

def _label_key(labelnames: Tuple[str, ...], kw: Dict) -> Tuple[str, ...]:
    if set(kw) != set(labelnames):
        raise ValueError(f"expected labels {labelnames}, got {tuple(kw)}")
    return tuple(str(kw[n]) for n in labelnames)


class _Bound:
    """One (metric, label-values) child; holds its own scalar/list."""
    __slots__ = ("_metric", "_key")

    def __init__(self, metric, key):
        self._metric = metric
        self._key = key


class _BoundCounter(_Bound):
    def inc(self, amount=1):
        if amount < 0:
            raise ValueError("counters only go up")
        v = self._metric._values
        v[self._key] = v.get(self._key, 0) + amount

    def value(self):
        return self._metric._values.get(self._key, 0)


class _BoundGauge(_Bound):
    def set(self, value):
        self._metric._values[self._key] = value

    def inc(self, amount=1):
        v = self._metric._values
        v[self._key] = v.get(self._key, 0) + amount

    def dec(self, amount=1):
        self.inc(-amount)

    def value(self):
        return self._metric._values.get(self._key, 0)


class _BoundHistogram(_Bound):
    def observe(self, value):
        m = self._metric
        obs, meta = m._series(self._key)
        meta[0] += 1                       # count
        meta[1] += value                   # sum
        if len(obs) >= m.max_observations:
            obs[meta[0] % m.max_observations] = value     # ring overwrite
        else:
            obs.append(value)

    def count(self):
        return self._metric._meta.get(self._key, (0, 0.0))[0]

    def sum(self):
        return self._metric._meta.get(self._key, (0, 0.0))[1]

    def values(self):
        return list(self._metric._obs.get(self._key, ()))

    def percentile(self, q):
        obs = self._metric._obs.get(self._key)
        if not obs:
            return float("nan")
        srt = sorted(obs)
        idx = min(len(srt) - 1, max(0, round(q / 100.0 * (len(srt) - 1))))
        return srt[idx]


class _Metric:
    kind = "untyped"
    _bound_cls = _Bound

    def __init__(self, name: str, help: str, labelnames: Tuple[str, ...]):
        self.name = name
        self.help = help
        self.labelnames = tuple(labelnames)
        self._children: Dict[Tuple[str, ...], _Bound] = {}

    def labels(self, **kw):
        key = _label_key(self.labelnames, kw)
        child = self._children.get(key)
        if child is None:
            child = self._bound_cls(self, key)
            self._children[key] = child
        return child

    def _default(self):
        """The unlabelled child (only valid when labelnames is empty)."""
        return self.labels()

    # convenience pass-throughs for label-less metrics
    def inc(self, amount=1):
        self._default().inc(amount)

    def value(self, **kw):
        return self.labels(**kw).value() if kw or not self.labelnames \
            else self._no_labels_error()

    def _no_labels_error(self):
        raise ValueError(f"{self.name} has labels {self.labelnames}; "
                         "use .labels(...)")


class Counter(_Metric):
    kind = "counter"
    _bound_cls = _BoundCounter

    def __init__(self, name, help, labelnames):
        super().__init__(name, help, labelnames)
        self._values: Dict[Tuple[str, ...], float] = {}

    def total(self):
        return sum(self._values.values())

    def items(self):
        return dict(self._values)


class Gauge(_Metric):
    kind = "gauge"
    _bound_cls = _BoundGauge

    def __init__(self, name, help, labelnames):
        super().__init__(name, help, labelnames)
        self._values: Dict[Tuple[str, ...], float] = {}

    def set(self, value):
        self._default().set(value)

    def total(self):
        return sum(self._values.values())

    def items(self):
        return dict(self._values)


class Histogram(_Metric):
    kind = "histogram"
    _bound_cls = _BoundHistogram

    def __init__(self, name, help, labelnames, max_observations: int = 65536):
        super().__init__(name, help, labelnames)
        self.max_observations = max_observations
        self._obs: Dict[Tuple[str, ...], List[float]] = {}
        self._meta: Dict[Tuple[str, ...], List[float]] = {}  # [count, sum]

    def _series(self, key):
        obs = self._obs.get(key)
        if obs is None:
            obs = self._obs[key] = []
            self._meta[key] = [0, 0.0]
        return obs, self._meta[key]

    def observe(self, value):
        self._default().observe(value)

    def all_values(self) -> List[float]:
        """Every observation across all label children (merged)."""
        out: List[float] = []
        for obs in self._obs.values():
            out.extend(obs)
        return out

    def total_count(self):
        return sum(m[0] for m in self._meta.values())

    def items(self):
        return {k: (m[0], m[1]) for k, m in self._meta.items()}


# ---------------------------------------------------------------------------
# registry
# ---------------------------------------------------------------------------

class MetricsRegistry:
    """Holds every metric plus a bounded JSONL event stream.

    ``enabled=False`` makes every factory return the shared no-op metric
    and drops events — the cheap-off switch the overhead bench pins.
    Metric factories are idempotent by name; re-registering with a
    different type or label set is an error (it would silently fork the
    series).
    """

    def __init__(self, enabled: bool = True, max_events: int = 100_000):
        self.enabled = enabled
        self.max_events = max_events
        self._metrics: Dict[str, _Metric] = {}
        self.events: List[Dict] = []
        self.events_dropped = 0
        self._t0 = time.perf_counter()

    # -- factories -----------------------------------------------------------

    def _get(self, cls, name, help, labelnames, **kw):
        if not self.enabled:
            return NOOP
        m = self._metrics.get(name)
        if m is None:
            m = cls(name, help, tuple(labelnames), **kw)
            self._metrics[name] = m
        elif not isinstance(m, cls) or m.labelnames != tuple(labelnames):
            raise ValueError(
                f"metric {name!r} already registered as {m.kind} with "
                f"labels {m.labelnames}")
        return m

    def counter(self, name: str, help: str = "",
                labelnames: Iterable[str] = ()) -> Counter:
        return self._get(Counter, name, help, labelnames)

    def gauge(self, name: str, help: str = "",
              labelnames: Iterable[str] = ()) -> Gauge:
        return self._get(Gauge, name, help, labelnames)

    def histogram(self, name: str, help: str = "",
                  labelnames: Iterable[str] = (),
                  max_observations: int = 65536) -> Histogram:
        return self._get(Histogram, name, help, labelnames,
                         max_observations=max_observations)

    # -- events --------------------------------------------------------------

    def event(self, name: str, **fields) -> None:
        """Append one lifecycle event (JSONL-exportable). Bounded: past
        ``max_events`` the newest events are dropped and counted."""
        if not self.enabled:
            return
        if len(self.events) >= self.max_events:
            self.events_dropped += 1
            return
        self.events.append(
            {"event": name, "t": time.perf_counter() - self._t0, **fields})

    def dump_events_jsonl(self, fp: IO[str]) -> int:
        """Write the event stream as JSON lines; returns lines written."""
        for ev in self.events:
            fp.write(json.dumps(ev) + "\n")
        return len(self.events)

    # -- export --------------------------------------------------------------

    def snapshot(self) -> Dict:
        """{kind: {name: {label-string: value}}} plus event accounting.
        Histogram values are (count, sum) pairs; use :meth:`percentiles`
        or ``histogram(...).all_values()`` for the distribution."""
        out: Dict = {"counters": {}, "gauges": {}, "histograms": {},
                     "events": len(self.events),
                     "events_dropped": self.events_dropped}
        for name, m in self._metrics.items():
            if isinstance(m, (Counter, Gauge)):
                sect = "counters" if isinstance(m, Counter) else "gauges"
                out[sect][name] = {self._lbl(m, k): v
                                   for k, v in m.items().items()}
            elif isinstance(m, Histogram):
                out["histograms"][name] = {
                    self._lbl(m, k): {"count": c, "sum": s}
                    for k, (c, s) in m.items().items()}
        return out

    @staticmethod
    def _escape_label_value(v: str) -> str:
        """Prometheus exposition escaping: backslash, double-quote and
        newline must be escaped inside label values or the scrape line
        is unparseable (tenant namespaces are user-supplied strings)."""
        return (v.replace("\\", r"\\").replace("\n", r"\n")
                 .replace('"', r'\"'))

    @classmethod
    def _lbl(cls, m: _Metric, key: Tuple[str, ...]) -> str:
        return ",".join(f'{n}="{cls._escape_label_value(v)}"'
                        for n, v in zip(m.labelnames, key))

    def prometheus_text(self, quantiles=(0.5, 0.95, 0.99)) -> str:
        """Prometheus exposition format; histograms export summary-style
        quantile rows computed from the retained observations."""
        lines: List[str] = []
        for name, m in sorted(self._metrics.items()):
            if m.help:
                lines.append(f"# HELP {name} {m.help}")
            kind = "summary" if isinstance(m, Histogram) else m.kind
            lines.append(f"# TYPE {name} {kind}")
            if isinstance(m, (Counter, Gauge)):
                for key, v in sorted(m.items().items()):
                    lbl = self._lbl(m, key)
                    lines.append(f"{name}{{{lbl}}} {v}" if lbl
                                 else f"{name} {v}")
            else:
                for key, (c, s) in sorted(m.items().items()):
                    lbl = self._lbl(m, key)
                    child = m._children.get(key)
                    for q in quantiles:
                        ql = (f'{lbl},quantile="{q}"' if lbl
                              else f'quantile="{q}"')
                        pv = child.percentile(q * 100) if child else 0.0
                        lines.append(f"{name}{{{ql}}} {pv}")
                    sfx = f"{{{lbl}}}" if lbl else ""
                    lines.append(f"{name}_sum{sfx} {s}")
                    lines.append(f"{name}_count{sfx} {c}")
        return "\n".join(lines) + ("\n" if lines else "")

    # -- aggregation helpers (reporter / tests) ------------------------------

    def value_sum(self, name: str) -> float:
        """Sum of a counter/gauge across all label children (0 if the
        metric does not exist — reporters read optimistically)."""
        m = self._metrics.get(name)
        if m is None or not isinstance(m, (Counter, Gauge)):
            return 0
        return m.total()

    def percentiles(self, name: str, qs=(50, 95, 99)) -> Dict[str, float]:
        """Merged-percentile summary of a histogram across label children."""
        m = self._metrics.get(name)
        vals = m.all_values() if isinstance(m, Histogram) else []
        from .trace import percentiles as _p
        return _p(vals, qs)


# ---------------------------------------------------------------------------
# legacy `.stats` compatibility
# ---------------------------------------------------------------------------

class StatsView(_MappingABC):
    """Read-only dict-like view: legacy stat names -> live registry reads.

    ``engine.stats["preemptions"]`` (and ``dict(engine.stats)``,
    ``.items()``, ``in``) keep working, but the numbers come from the
    registry — there is exactly one copy of every count.
    """

    def __init__(self, getters: Mapping[str, Callable[[], float]]):
        self._getters = dict(getters)

    def __getitem__(self, key: str):
        return self._getters[key]()

    def __iter__(self):
        return iter(self._getters)

    def __len__(self):
        return len(self._getters)

    def __repr__(self):
        return repr({k: g() for k, g in self._getters.items()})
