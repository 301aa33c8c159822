"""The port's kernel timing (``obs/profiling.py``), Chrome-trace export
(``obs/export.py``), ``obs`` exports, metric-name table and the serve
CLI's ``--legacy``, ``--metrics``, ``--metrics-out``, ``--kernel-timing``
and ``--trace-out``, on the CPU.

Counterparts of ``tests/test_obs.py`` (dispatch timing on and off,
skipped while tracing, every dispatcher recording under the reference's
kernel name) and ``tests/test_spans.py`` (the Chrome-trace golden
schema, pairing, the multi-replica clock, instants, the empty recorder,
the engine's spans). The port's trace must equal the reference's, event
for event, on the same span records. On the CPU the dispatchers run the
kernels' plain versions: timing them records the same series and leaves
every launch counter at 0, as with timing off.
"""
import json
import re
import warnings
from pathlib import Path

import numpy as np
import pytest
import torch

from repro import obs as jobs
from repro.obs import export as jexport
from repro.obs import spans as jspans
from repro_torch import obs
from repro_torch.configs import registry
from repro_torch.kernels import ops
from repro_torch.launch import serve
from repro_torch.models import transformer as T
from repro_torch.obs import MetricsRegistry, SpanRecorder, profiling
from repro_torch.obs.export import chrome_trace, dump_chrome_trace
from repro_torch.serving import Engine, Request

# one intra-op thread: the suite's pytest-xdist workers share the
# cores, and oversubscribed OpenMP pools spin against each other
torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
SRC = ROOT / "src"


def _hist(reg):
    return reg.histogram("kernel_dispatch_seconds", "", ("kernel",))


# ---------------------------------------------------------------------------
# profiling hooks
# ---------------------------------------------------------------------------

def test_dispatch_times_calls_when_enabled():
    reg = MetricsRegistry()
    try:
        profiling.enable_kernel_timing(reg)
        assert profiling.kernel_timing_enabled()
        out = profiling.dispatch("toy", lambda: torch.ones(4) * 2)
        assert torch.equal(out, torch.full((4,), 2.0))
        h = _hist(reg)
        assert h.labels(kernel="toy").count() == 1
        assert h.labels(kernel="toy").sum() > 0
    finally:
        profiling.disable_kernel_timing()
    assert not profiling.kernel_timing_enabled()
    profiling.dispatch("toy", lambda: torch.ones(4))
    assert h.labels(kernel="toy").count() == 1     # off: nothing recorded
    other = MetricsRegistry()                      # an explicit registry
    profiling.dispatch("toy", lambda: torch.ones(4), registry=other)
    assert _hist(other).labels(kernel="toy").count() == 1


def test_dispatch_skips_timing_while_compiling():
    """The counterpart of skipping jit tracers: under ``torch.compile``
    tracing (``torch.compiler.is_compiling()``) nothing is timed."""
    reg = MetricsRegistry()
    try:
        profiling.enable_kernel_timing(reg)

        @torch.compile(backend="eager", fullgraph=False)
        def f(x):
            return profiling.dispatch("traced", lambda: x * 3)
        assert torch.equal(f(torch.ones(2)), torch.full((2,), 3.0))
        assert _hist(reg).labels(kernel="traced").count() == 0
    finally:
        profiling.disable_kernel_timing()
        torch._dynamo.reset()


def test_dispatch_annotates_under_the_profiler():
    """With a profiler recording, the dispatch is a named range (the
    counterpart of ``jax.named_scope``), timing on or off."""
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU]) as prof:
        profiling.dispatch("named_kernel", lambda: torch.ones(8) + 1)
    assert "named_kernel" in {e.key for e in prof.key_averages()}


def _every_dispatcher():
    """One small CPU call of each dispatcher -> {kernel name: output}."""
    from repro_torch.core import spinner
    from repro_torch.kernels import seedgen
    gen = torch.Generator().manual_seed(0)
    pool = torch.randn(4, 2, 8, generator=gen)
    qpool = torch.randint(-127, 128, (4, 2, 8), generator=gen).to(torch.int8)
    scales = torch.rand(4, 2, 1, generator=gen)
    tables = torch.tensor([[1, 2], [3, 0]])
    pipe = spinner.single("circulant", 16, 8)
    params = pipe.init(gen)
    x = torch.randn(3, 8, generator=gen)
    s, z = torch.randn(2, 3, 6, 5, generator=gen), torch.rand(2, 3, 6,
                                                               generator=gen)
    pq, pk = (torch.rand(2, 3, 6, generator=gen) for _ in range(2))
    v = torch.randn(2, 3, 5, generator=gen)
    return {
        "fwht": ops.fwht(torch.randn(4, 16, generator=gen)),
        "circulant_project": ops.circulant_project(
            torch.randn(2, 8, generator=gen), x, 12),
        "paged_gather": ops.paged_gather(pool, tables),
        "paged_gather_kv": ops.paged_gather_kv(pool, pool[..., :3], tables),
        "paged_gather_dequant": ops.paged_gather_dequant(qpool, scales,
                                                         tables),
        "paged_gather_dequant_kv": ops.paged_gather_dequant_kv(
            qpool, scales, qpool, scales, tables),
        "srf_decode": ops.srf_decode(s, z, pq, pk, v),
        "spinner_project": ops.spinner_project(
            "circulant", params[0], x, 16),
        "spinner_project_seeded": ops.spinner_project_seeded(
            "circulant", seedgen.words(7), x, 16)}


KERNELS = ["spinner_project", "spinner_project_seeded", "srf_decode",
           "paged_gather", "paged_gather_kv", "paged_gather_dequant",
           "paged_gather_dequant_kv",
           "fwht", "circulant_project"]


def test_ops_dispatch_records_kernel_histogram():
    """Every dispatcher records one dispatch under its kernel's name with
    timing on; outputs and launch counters are the same on and off."""
    ops.reset_counts()
    off = _every_dispatcher()
    counts_off = ops.launch_counts()
    reg = MetricsRegistry()
    try:
        profiling.enable_kernel_timing(reg)
        on = _every_dispatcher()
    finally:
        profiling.disable_kernel_timing()
    assert ops.launch_counts() == counts_off
    assert all(n == 0 for n in counts_off.values())
    h = _hist(reg)
    assert sorted(off) == sorted(KERNELS)
    for name in KERNELS:
        assert h.labels(kernel=name).count() == 1, name
        a, b = off[name], on[name]
        for x, y in zip(a if isinstance(a, tuple) else (a,),
                        b if isinstance(b, tuple) else (b,)):
            assert torch.equal(x, y), name
    snap = reg.snapshot()["histograms"]["kernel_dispatch_seconds"]
    assert set(snap) == {f'kernel="{k}"' for k in KERNELS}


@pytest.mark.parametrize("arch", ["qwen3-4b", "deepseek-v2-lite-16b"],
                         ids=["full KV", "MLA"])
def test_paged_step_dispatches_one_pair_gather_a_layer(arch):
    """One paged step (a chunk of 3 tokens on 2 rows) of the reduced
    config dispatches paged_gather_kv exactly once a layer (K and V, or
    MLA's c and kpe) and paged_gather never; the dispatches are timed
    into kernel_dispatch_seconds{kernel="paged_gather_kv"}."""
    from repro_torch.serving import paged_cache
    cfg = registry.reduced(arch)
    params = T.init(cfg, seed=0, device="cpu")
    pools = paged_cache.init_pools(cfg, 9, 4, num_slots=4, device="cpu")
    gen = torch.Generator().manual_seed(0)
    tok = torch.randint(0, cfg.vocab, (2, 3), generator=gen)
    pos = torch.arange(3).repeat(2, 1)
    reg = MetricsRegistry()
    try:
        profiling.enable_kernel_timing(reg)
        logits, _ = T.paged_step(params, cfg, pools, tok, pos,
                                 torch.ones(2, 3, dtype=torch.bool),
                                 torch.tensor([[1, 2], [3, 4]]),
                                 torch.tensor([1, 2]))
    finally:
        profiling.disable_kernel_timing()
    assert torch.isfinite(logits).all()
    snap = reg.snapshot()["histograms"]["kernel_dispatch_seconds"]
    assert set(snap) == {'kernel="paged_gather_kv"'}
    assert snap['kernel="paged_gather_kv"']["count"] == cfg.n_layers


def test_timing_leaves_grad_paths_alone():
    """The plain versions stay differentiable under timing (the dispatch
    wrapper adds nothing to the autograd graph)."""
    x = torch.randn(4, 16, requires_grad=True)
    reg = MetricsRegistry()
    try:
        profiling.enable_kernel_timing(reg)
        y = ops.fwht(x)
    finally:
        profiling.disable_kernel_timing()
    (g,) = torch.autograd.grad(y.sum(), x)
    (g0,) = torch.autograd.grad(ops.fwht(x).sum(), x)
    assert torch.equal(g, g0)


def test_obs_exports_match_reference():
    def public(mod):
        return {n for n in dir(mod) if not n.startswith("_")
                and not isinstance(getattr(mod, n), type(json))}
    assert public(jobs) == public(obs)


# ---------------------------------------------------------------------------
# Chrome-trace export: the reference's golden tests, and equality with it
# ---------------------------------------------------------------------------

def _golden_recorders(mod=None):
    cls = SpanRecorder if mod is None else mod.SpanRecorder
    r0 = cls(replica=0)
    root = r0.complete("engine_step", 1.0, 1.5, rows=2)
    r0.complete("prefill_step", 1.1, 1.3, parent=root)
    r0.complete("decode_step", 1.3, 1.5, parent=root)
    r1 = cls(replica=1)
    r1.complete("engine_step", 1.2, 1.4, uid=9)
    return [r0, r1]


def test_chrome_trace_golden_schema(tmp_path):
    recs = _golden_recorders()
    path = tmp_path / "trace.json"
    n = dump_chrome_trace(str(path), recs)
    doc = json.loads(path.read_text())
    assert set(doc) == {"traceEvents", "displayTimeUnit"}
    evs = doc["traceEvents"]
    assert n == len(evs)
    meta = [e for e in evs if e["ph"] == "M"]
    assert {e["args"]["name"] for e in meta} == {"replica 0", "replica 1"}
    be = [e for e in evs if e["ph"] in "BE"]
    for e in be:
        assert {"name", "ph", "pid", "tid", "ts"} <= set(e)
        assert isinstance(e["ts"], float) and e["ts"] >= 0.0
    assert min(e["ts"] for e in be) == 0.0


def test_chrome_trace_begin_end_paired_and_monotonic():
    doc = chrome_trace(_golden_recorders())
    for pid in (0, 1):
        seq = [e for e in doc["traceEvents"]
               if e.get("pid") == pid and e["ph"] in "BE"]
        assert all(a["ts"] <= b["ts"] for a, b in zip(seq, seq[1:]))
        stack = []
        for e in seq:
            if e["ph"] == "B":
                stack.append(e["name"])
            else:
                assert stack.pop() == e["name"]
        assert stack == []


def test_chrome_trace_merges_replicas_onto_one_clock():
    evs = chrome_trace(_golden_recorders())["traceEvents"]
    b0 = next(e for e in evs if e["pid"] == 0 and e["ph"] == "B"
              and e["name"] == "engine_step")
    b1 = next(e for e in evs if e["pid"] == 1 and e["ph"] == "B")
    assert b1["ts"] - b0["ts"] == 200000.0
    assert b1["args"]["uid"] == 9


def test_chrome_trace_instants():
    r = SpanRecorder(replica=3)
    r.complete("step", 2.0, 3.0)
    r.instant("prefix_hit", uid=5, tokens=8)
    evs = chrome_trace([r])["traceEvents"]
    (i,) = [e for e in evs if e["ph"] == "i"]
    assert i["s"] == "t" and i["pid"] == 3
    assert i["args"]["uid"] == 5 and i["args"]["tokens"] == 8


def test_chrome_trace_empty_recorder():
    assert chrome_trace(SpanRecorder())["traceEvents"] == []


def _replay(mod, recorder_cls):
    """The same span records in a recorder of either package: the golden
    spans, an instant, overlapping and unsorted spans, a replica-less
    recorder and a span on a second recorder of replica 1."""
    r0 = recorder_cls(replica=0)
    root = r0.complete("engine_step", 5.0, 5.9, rows=4)
    r0.complete("decode_step", 5.5, 5.9, parent=root, rows=4)
    r0.complete("prefill_step", 5.1, 5.4, parent=root)
    r0.complete("sample", 5.6, 5.7)
    r0.complete("late", 5.8, 6.5)
    r0.instant("cow_fork", pages=2)
    r1 = recorder_cls(replica=1)
    r1.complete("engine_step", 5.2, 5.3, uid=3)
    r2 = recorder_cls()
    r2.complete("admit", 5.05, 5.06, admitted=1)
    return [r0, r1, r2]


def test_chrome_trace_equals_reference_on_the_same_spans():
    """The port's export of span records equals the reference's: the
    events (instants carry their own clock reads, so they are compared
    without ``ts``), and the whole document on the golden spans."""
    assert chrome_trace(_golden_recorders()) == \
        jexport.chrome_trace(_golden_recorders(jspans))
    got = chrome_trace(_replay(None, SpanRecorder))["traceEvents"]
    want = jexport.chrome_trace(_replay(None, jspans.SpanRecorder)
                                )["traceEvents"]

    def strip(evs):
        return [{k: v for k, v in e.items()
                 if not (e["ph"] == "i" and k == "ts")} for e in evs]
    assert strip(got) == strip(want)
    assert len(got) == len(want) > 10
    # the reference's exporter also reads the port's records (same fields)
    recs = _replay(None, SpanRecorder)
    spans_only = [s for r in recs for s in r.snapshot() if s.kind == "span"]
    assert chrome_trace(spans_only) == jexport.chrome_trace(spans_only)


def test_engine_records_step_spans_and_export_loads():
    cfg = registry.reduced("qwen3-4b", n_layers=2)
    params = T.init(cfg, seed=0, device="cpu")
    rec = SpanRecorder(replica=0)
    eng = Engine(cfg, params, batch_slots=2, max_len=64, spans=rec,
                 device="cpu")
    for i in range(3):
        eng.submit(Request(uid=i, prompt=np.arange(4, dtype=np.int32),
                           max_new=4))
    eng.run()
    names = {s.name for s in rec.snapshot()}
    assert {"engine_step", "admit", "prefill_step", "decode_step",
            "sample"} <= names
    steps = {s.sid for s in rec.snapshot() if s.name == "engine_step"}
    by_name = {}
    for s in rec.snapshot():
        by_name.setdefault(s.name, s)
    assert by_name["prefill_step"].parent in steps
    assert by_name["decode_step"].parent in steps
    doc = chrome_trace(rec)
    assert json.loads(json.dumps(doc)) == doc
    assert any(e["ph"] == "B" for e in doc["traceEvents"])


# ---------------------------------------------------------------------------
# the metric-name table
# ---------------------------------------------------------------------------

def test_metric_name_table_in_readme_is_complete():
    """src/repro_torch/serving/README.md documents every metric series
    the port's serving/ and obs/ register (string-literal first argument
    of counter() / gauge() / histogram() calls and of the one-letter
    factory aliases)."""
    pat = re.compile(r'\.(?:counter|gauge|histogram)\(\s*"([a-z0-9_]+)"',
                     re.S)
    alias = re.compile(r'(?<![\w.])[cgh]\(\s*"([a-z0-9_]+)"', re.S)
    names = set()
    for root in (SRC / "repro_torch" / "serving", SRC / "repro_torch" /
                 "obs"):
        for f in sorted(root.rglob("*.py")):
            text = f.read_text()
            names.update(pat.findall(text))
            names.update(alias.findall(text))
    assert len(names) > 20 and "kernel_dispatch_seconds" in names
    readme = (SRC / "repro_torch" / "serving" / "README.md").read_text()
    missing = sorted(n for n in names if n not in readme)
    assert not missing, "metrics registered but undocumented in " \
        "src/repro_torch/serving/README.md: " + ", ".join(missing)


# ---------------------------------------------------------------------------
# the serve CLI
# ---------------------------------------------------------------------------

CLI = ["--arch", "qwen3-4b", "--reduced", "--device", "cpu", "--requests",
       "3", "--prompt-len", "6", "--max-new", "4"]


@pytest.mark.parametrize("attn", ["full", "srf"])
def test_cli_legacy_serves(capsys, attn, tmp_path):
    """``--legacy`` serves every request through the per-slot engine,
    records no spans (no trace file) and prints the engine=legacy line;
    kernel timing with SRF records the spinner's dispatches, with full
    KV (which calls no kernel op) the note that nothing was recorded."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        from repro_torch.serving import legacy   # noqa: F401
    trace = tmp_path / "t.json"
    argv = CLI + ["--attn", attn, "--legacy", "--kernel-timing",
                  "--trace-out", str(trace), "--metrics"]
    assert serve.main(argv) == 0
    out = capsys.readouterr().out
    assert f"attn={attn} engine=legacy" in out
    assert "requests=3 tokens=12" in out
    assert not trace.exists() and "[trace]" not in out
    assert "[metrics] t=" not in out              # no periodic line
    assert "[metrics] ---- final ----" in out
    if attn == "srf":
        assert 'kernel kernel="spinner_project"' in out
        assert "no kernel dispatches recorded" not in out
    else:
        assert "no kernel dispatches recorded" in out
    assert not profiling.kernel_timing_enabled()


def test_cli_metrics_and_trace_files(capsys, tmp_path):
    """The paged engine with ``--metrics --metrics-every 0
    --metrics-out F --kernel-timing --trace-out T``: the periodic line,
    the final dump, the exposition and event files, per-kernel timing,
    and a trace that loads with paired B/E events."""
    prom, trace = tmp_path / "m.prom", tmp_path / "t.json"
    argv = CLI + ["--attn", "srf", "--metrics", "--metrics-every", "0",
                  "--metrics-out", str(prom), "--kernel-timing",
                  "--trace-out", str(trace)]
    assert serve.main(argv) == 0
    out = capsys.readouterr().out
    assert "engine=paged" in out and "requests=3 tokens=12" in out
    assert "[metrics] t=" in out
    assert f"[metrics] dumped {prom}" in out
    text = prom.read_text()
    assert "engine_tokens_total" in text
    assert 'kernel_dispatch_seconds_count{kernel="srf_decode"}' in text
    assert 'kernel_dispatch_seconds_count{kernel="spinner_project"}' in text
    events = [json.loads(line) for line in
              Path(str(prom) + ".events.jsonl").read_text().splitlines()]
    assert sum(e["event"] == "done" for e in events) == 3
    doc = json.loads(trace.read_text())
    be = [e for e in doc["traceEvents"] if e["ph"] in "BE"]
    assert be and sum(e["ph"] == "B" for e in be) == \
        sum(e["ph"] == "E" for e in be)
    assert all(a["ts"] <= b["ts"] for a, b in zip(be, be[1:]))
    assert f"[trace] {trace}:" in out
    assert not profiling.kernel_timing_enabled()


def test_cli_without_telemetry_flags_writes_nothing(capsys):
    assert serve.main(CLI) == 0
    out = capsys.readouterr().out
    assert "engine=paged" in out and "[metrics]" not in out
    assert "[trace]" not in out


def test_cli_legacy_engine_takes_the_seed():
    """The port's CLI keys the legacy engine's sampling with ``--seed``,
    as it keys the paged engine's (the reference's CLI leaves the legacy
    engine at seed 0)."""
    from repro_torch.kernels import seedgen
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        from repro_torch.serving import legacy
    args = serve.parser().parse_args(CLI + ["--legacy", "--seed", "4"])
    cfg = registry.reduced("qwen3-4b", n_layers=2)
    eng = serve.engine(args, cfg, T.init(cfg, seed=0, device="cpu"))
    assert isinstance(eng, legacy.Engine)
    assert torch.equal(eng._base_key, seedgen.threefry_seed(4))


@pytest.mark.parametrize("flag", [["--legacy"], ["--kernel-timing"],
                                  ["--metrics"], ["--metrics-out", "m"],
                                  ["--trace-out", "t"]])
def test_profile_serve_refuses_the_telemetry_flags(flag, capsys):
    """profile_serve takes the serve CLI's parser but profiles the paged
    engine untimed: the legacy and telemetry flags are usage errors."""
    from repro_torch.launch import profile_serve
    with pytest.raises(SystemExit) as exc:
        profile_serve.main(["--arch", "qwen3-4b", "--device", "cpu"] + flag)
    assert exc.value.code == 2
    assert "the serve CLI's" in capsys.readouterr().err
