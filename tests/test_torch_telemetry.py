"""The port engine's telemetry against ``repro.serving.Engine`` on the
CPU, the serve CLI's ``--policy`` and ``--deadline``, and the print-free
serving stack.

Both engines serve the same reduced traffic (2-layer qwen3-4b, full-KV
f32 pages, the reference's params carried over): two tenant
namespaces, requests whose 0-second deadline expires while they wait,
and a pool tight enough to preempt. They must register the same metric
series, count the same per-tenant tokens and requests, publish equal
pool gauges, and emit the same sequence of event names; with a span
recorder, the same span and instant names.
"""
import re
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro import serving as jserving
from repro.configs import registry as jregistry
from repro.models import transformer as jT
from repro.obs import spans as jspans
from repro_torch import convert
from repro_torch.configs import registry
from repro_torch.launch import serve
from repro_torch.obs import spans
from repro_torch.obs.report import Reporter
from repro_torch.serving import Engine, Request, SchedConfig

# one intra-op thread: the suite's pytest-xdist workers share the
# cores, and oversubscribed OpenMP pools spin against each other
torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
TENANT = ("tenant_prefill_tokens_total", "tenant_decode_tokens_total",
          "tenant_requests_total", "tenant_expired_total")
GEO = dict(max_batch=4, prefill_batch=2, prefill_chunk=4, page_size=4,
           table_width=4, num_pages=9)


@pytest.fixture(scope="module")
def kv_models():
    jcfg = jregistry.reduced("qwen3-4b", n_layers=2)
    cfg = registry.reduced("qwen3-4b", n_layers=2)
    jparams = jT.init(jax.random.PRNGKey(0), jcfg)
    params = convert.params_from_jax(jax.tree.map(np.asarray, jparams), cfg,
                                     device="cpu")
    return jcfg, jparams, cfg, params


def _traffic(cls, cfg):
    """Six requests in tenants "a" and "b"; uids 4 and 5 carry a deadline
    of 0 s and expire before their first admission."""
    rng = np.random.default_rng(0)
    return [cls(uid=i, prompt=rng.integers(0, cfg.vocab, 3 + i % 2)
                .astype(np.int32), max_new=10, namespace="ab"[i % 2],
                deadline=0.0 if i >= 4 else None) for i in range(6)]


def _serve(eng, reqs, on_step=None):
    for r in reqs:
        eng.submit(r)
    return eng.run(on_step=on_step)


def _tenant_values(snap):
    """{series: {tenant: value}} of the per-tenant counters; the engine
    label is dropped (engine ids differ between the two packages)."""
    return {name: {re.search(r'tenant="([^"]*)"', lbl).group(1): val
                   for lbl, val in snap["counters"][name].items()}
            for name in TENANT}


@pytest.fixture(scope="module")
def served(kv_models):
    jcfg, jparams, cfg, params = kv_models
    jrec, rec = jspans.SpanRecorder(), spans.SpanRecorder()
    jeng = jserving.Engine(jcfg, jparams, batch_slots=4, max_len=16,
                           sched=jserving.SchedConfig(**GEO), spans=jrec)
    steps = []
    eng = Engine(cfg, params, batch_slots=4, max_len=16, device="cpu",
                 sched=SchedConfig(**GEO), spans=rec)
    jdone = _serve(jeng, _traffic(jserving.Request, jcfg))
    done = _serve(eng, _traffic(Request, cfg), on_step=steps.append)
    return jeng, jdone, jrec, eng, done, rec, steps


def test_telemetry_series_match_reference(served):
    jeng, jdone, _, eng, done, _, _ = served
    jsnap, snap = jeng.metrics.snapshot(), eng.metrics.snapshot()
    for kind in ("counters", "gauges", "histograms"):
        assert set(snap[kind]) == set(jsnap[kind]), kind
    assert eng.stats["preemptions"] > 0, "the pool did not preempt"
    assert dict(eng.stats) == dict(jeng.stats)
    assert _tenant_values(snap) == _tenant_values(jsnap)
    tv = _tenant_values(snap)
    assert tv["tenant_expired_total"] == {"a": 1, "b": 1}
    assert sum(tv["tenant_requests_total"].values()) == 4
    assert sorted(r.finish_reason for r in done) == \
        sorted(r.finish_reason for r in jdone)
    for name in ("pool_bytes", "pool_bytes_per_device"):
        assert eng.metrics.value_sum(name) == jeng.metrics.value_sum(name)
    assert eng.metrics.value_sum("pool_bytes") == \
        eng.metrics.value_sum("pool_bytes_per_device") > 0
    rep = eng.cache_report()
    assert rep["pool_bytes_per_device"] == rep["pool_bytes"] == \
        jeng.cache_report()["pool_bytes_per_device"]


def test_event_sequence_matches_reference(served):
    jeng, _, _, eng, _, _, _ = served
    got = [e["event"] for e in eng.metrics.events]
    want = [e["event"] for e in jeng.metrics.events]
    assert got == want
    for name in ("queued", "expired", "done", "preempted", "restored"):
        assert name in got, name


def test_spans_and_on_step(served):
    jeng, _, jrec, eng, _, rec, steps = served
    names = {s.name for s in rec.snapshot()}
    assert names == {s.name for s in jrec.snapshot()}
    for name in ("engine_step", "prefill_step", "decode_step", "sample",
                 "prefill_chunk", "preempt", "admit"):
        assert name in names, name
    n_steps = sum(s.name == "engine_step" for s in rec.snapshot())
    (hist,) = eng.metrics.snapshot()["histograms"][
        "engine_step_seconds"].values()
    assert steps and all(e is eng for e in steps)
    assert len(steps) == n_steps == hist["count"]


def test_engine_without_spans_records_nothing(kv_models):
    _, _, cfg, params = kv_models
    eng = Engine(cfg, params, batch_slots=2, max_len=16, device="cpu")
    assert eng.spans is spans.NOOP
    _serve(eng, [Request(uid=0, prompt=np.arange(3, dtype=np.int32),
                         max_new=2)])
    assert len(spans.NOOP) == 0


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------

CLI = ["--arch", "qwen3-4b", "--reduced", "--device", "cpu",
       "--requests", "4", "--prompt-len", "5", "--max-new", "3",
       "--slots", "2"]


def test_cli_policy_priority():
    args = serve.parser().parse_args(CLI + ["--policy", "priority"])
    assert args.policy == "priority"
    assert serve.parser().parse_args(CLI).policy == "fcfs"
    reqs = serve.requests(args, serve.config(args))
    assert {r.priority for r in reqs} <= {0, 1, 2}
    # the priorities come after the prompts: fcfs prompts are unchanged
    fcfs = serve.requests(serve.parser().parse_args(CLI),
                          serve.config(args))
    assert all(np.array_equal(a.prompt, b.prompt)
               for a, b in zip(reqs, fcfs))
    res = serve.serve(args)
    assert res["engine"].sched_cfg.policy == "priority"
    assert len(res["done"]) == 4 and res["tokens"] == 12


def test_cli_deadline_expires_waiting_requests(capsys):
    args = serve.parser().parse_args(CLI + ["--deadline", "0"])
    assert args.deadline == 0.0
    assert serve.parser().parse_args(CLI).deadline is None
    res = serve.serve(args)
    assert all(r.deadline == 0.0 for r in res["done"])
    assert {r.finish_reason for r in res["done"]} == {"timeout"}
    assert res["engine"].metrics.value_sum("engine_expired_total") == 4
    assert serve.main(CLI + ["--deadline", "0"]) == 0
    out = capsys.readouterr().out
    assert "requests=4 tokens=0" in out and "finish=timeout" in out


def test_cli_prints_through_reporter(monkeypatch, capsys):
    lines = []
    monkeypatch.setattr(Reporter, "line",
                        lambda self, msg: lines.append(msg))
    assert serve.main(CLI) == 0
    assert capsys.readouterr().out == ""
    assert lines and lines[0].startswith("arch=qwen3-4b")


def test_no_bare_print_in_serving():
    """The port's counterpart of ``tests/test_obs.py``'s pin: nothing in
    ``repro_torch/serving`` (the legacy engine included) or
    ``repro_torch/launch/serve.py`` prints; output goes through
    ``obs.report.Reporter``."""
    src = ROOT / "src" / "repro_torch"
    files = sorted((src / "serving").rglob("*.py"))
    assert src / "serving" / "legacy.py" in files
    files.append(src / "launch" / "serve.py")
    pat = re.compile(r"(?<![\w.])print\(")
    offenders = [f"{f.relative_to(ROOT)}:{i}: {line.strip()}"
                 for f in files
                 for i, line in enumerate(f.read_text().splitlines(), 1)
                 if pat.search(line)]
    assert len(files) > 5
    assert not offenders, "bare print() in the serving stack:\n" + \
        "\n".join(offenders)


def test_reporter_matches_reference(served):
    """The ported Reporter prints the reference's final report, line for
    line, when both read the same registry."""
    import io
    from repro.obs.report import Reporter as JReporter
    jeng, jdone, _, _, _, _, _ = served
    got, want = io.StringIO(), io.StringIO()
    Reporter(stream=got).final(jeng.metrics, jdone)
    JReporter(stream=want).final(jeng.metrics, jdone)
    assert got.getvalue() == want.getvalue()
    assert "[metrics] ---- final ----" in got.getvalue()
    tick = Reporter(stream=got).periodic(jeng.metrics, every_s=0.0)
    tick(None)
    assert "[metrics] t=" in got.getvalue().splitlines()[-1]
