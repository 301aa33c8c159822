"""What every cell shares: finding a cell, its configuration, its
traffic, its limits and its metric readers by the names in
``BENCHMARK.json``; the statistics the readers use; the check that no
JAX module was loaded; the result line.

Nothing here imports ``repro_torch``: the drivers under ``drivers/`` do,
and the references under ``refs/`` never do.
"""
from __future__ import annotations

import importlib.util
import json
import math
import sys
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent

# top-level module names that no run may load (compared whole: the port's
# name, ``repro_torch``, begins with the reference package's, ``repro``)
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


@dataclass
class Cell:
    """One entry of ``workloads`` with what it names, read from disk."""
    name: str
    chips: int
    config: Dict[str, Any]          # the configuration file as run
    traffic: Dict[str, Any]         # the traffic file
    end_to_end: List[Dict[str, Any]]
    per_layer: List[Dict[str, Any]]
    limits: Dict[str, float]


def load_benchmark(root: Path = ROOT) -> Dict[str, Any]:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def _applies(metric: Dict[str, Any], cell: str) -> bool:
    return cell in metric.get("workloads", [cell])


def find_cell(name: str, root: Path = ROOT) -> Cell:
    """The cell ``name`` of ``BENCHMARK.json``: its configuration file,
    its traffic file ``traffic/<traffic>.json``, its limits file
    ``limits/<cell>.json`` and the metrics that it reports."""
    bench = load_benchmark(root)
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; there are "
                       f"{sorted(cells)}")
    w = cells[name]
    conf = {c["name"]: c for c in bench["configs"]}[w["config"]]
    with open(root / conf["file"]) as f:
        config = json.load(f)
    with open(HERE / "traffic" / f"{w['traffic']}.json") as f:
        traffic = json.load(f)
    with open(HERE / "limits" / f"{name}.json") as f:
        limits = json.load(f)
    return Cell(name=name, chips=int(w["chips"]), config=config,
                traffic=traffic,
                end_to_end=[m for m in bench["end_to_end"]
                            if _applies(m, name)],
                per_layer=[m for m in bench["per_layer"]
                           if _applies(m, name)],
                limits={k: float(v["limit"]) for k, v in limits.items()})


def load_module(path: Path, name: str):
    """Import the file ``path`` as a module called ``name`` (metric
    readers carry dots in their file names, so they cannot be imported
    by name)."""
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reader(metric: str) -> Callable[[Dict[str, Any]], Optional[float]]:
    """The reader of ``metrics/<metric>.py``: ``read(run) -> value or
    None`` (None: nothing to read in this run, the metric is left out)."""
    path = HERE / "metrics" / f"{metric}.py"
    return load_module(path, "portbench_metric_" + metric.replace(".", "_")
                       ).read


def reference(name: str):
    """The plain reference ``refs/<name>.py`` of a configuration."""
    return load_module(HERE / "refs" / f"{name}.py", f"portbench_ref_{name}")


def driver(kind: str):
    """The driver ``drivers/<kind>.py`` of a traffic kind."""
    return load_module(HERE / "drivers" / f"{kind}.py",
                       f"portbench_driver_{kind}")


# -- statistics ---------------------------------------------------------------

def quantile(values: List[float], q: float) -> float:
    """The q-quantile of every value, linear between order statistics
    (numpy's default and ``statistics.quantiles(method="inclusive")``)."""
    xs = sorted(values)
    if not xs:
        raise ValueError("quantile of no values")
    pos = q * (len(xs) - 1)
    lo = math.floor(pos)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


def union_seconds(intervals: List[tuple]) -> float:
    """Length of the union of (start, end) intervals."""
    total, end = 0.0, -math.inf
    for a, b in sorted(intervals):
        if b <= end:
            continue
        total += b - max(a, end)
        end = b
    return total


def phases(t_process: float, marks: List) -> Dict[str, float]:
    """Seconds of each named stretch of set-up, each ending at its mark
    [(name, perf_counter)], the first starting at the process's start."""
    out, t = {}, t_process
    for name, at in marks:
        out[name] = at - t
        t = at
    return out


# -- the process --------------------------------------------------------------

def forbidden_modules(modules=None) -> List[str]:
    """Loaded modules whose top-level name is one of ``FORBIDDEN``."""
    mods = sys.modules if modules is None else modules
    return sorted(m for m in mods if m.split(".")[0] in FORBIDDEN)


@dataclass
class Result:
    correct: bool
    attempted: int
    failed: int
    metrics: Dict[str, Dict[str, Any]]
    device: Dict[str, Any]
    breakdown: Optional[Dict[str, Any]] = None
    check: Dict[str, Dict[str, float]] = field(default_factory=dict)

    def line(self) -> str:
        out: Dict[str, Any] = {"correct": self.correct,
                               "attempted": self.attempted,
                               "failed": self.failed,
                               "metrics": self.metrics,
                               "device": self.device}
        if self.breakdown is not None:
            out["breakdown"] = self.breakdown
        out["check"] = self.check          # last: each number by its limit
        return json.dumps(out)


def check_lines(record: Dict[str, Any],
                check: Dict[str, Dict[str, float]]) -> List[str]:
    """Standard error's last lines: each number read but not compared,
    then each compared number beside its limit."""
    return [f"set-up: " + ", ".join(f"{k} {v:.3f} s" for k, v in
                                     record["setup_phases"].items())] + \
        [f"read {k}: {v!r} (no limit: not compared)"
            for k, v in record["check"].items() if k not in check] + \
        [f"check {k}: {v['value']!r} limit {v['limit']!r}"
         for k, v in check.items()]


def result(cell: Cell, record: Dict[str, Any], trace: bool,
           device: Dict[str, Any]) -> Result:
    """The result line of a run record: the cell's end-to-end metrics
    (or, traced, its per-layer metrics, each by its reader), the device,
    and each compared number beside its limit: the cell's limits file
    names the numbers compared. ``correct`` needs an attempted request
    or step, none failed, and every number within its limit."""
    device = dict(device, memory_peak_bytes=record["memory_peak_bytes"])
    breakdown = None
    if trace and "trace" in record:
        from portbench import trace as trace_lib
        summary = trace_lib.reduce(*record["trace"], record["window_s"])
        record["trace_summary"] = summary
        device.update(busy_s=summary["busy_s"], window_s=summary["window_s"])
        breakdown = {"device_ops": summary["device_ops"],
                     "idle_gaps": summary["idle_gaps"]}
    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        value = reader(m["name"])(record)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    check = {k: {"value": v, "limit": cell.limits[k]}
             for k, v in record["check"].items() if k in cell.limits}
    correct = (record["attempted"] > 0 and record["failed"] == 0
               and all(c["value"] <= c["limit"] for c in check.values()))
    return Result(correct=correct, attempted=record["attempted"],
                  failed=record["failed"], metrics=metrics, device=device,
                  breakdown=breakdown, check=check)
