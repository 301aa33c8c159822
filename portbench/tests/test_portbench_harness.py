"""The harness on the CPU: cells, configurations, traffic and metric
readers found by name; the traffic's determinism and lengths; the
metric arithmetic on synthetic runs; the frozen cost copy against the
program's; and that nothing a run loads is JAX or the JAX package."""
from __future__ import annotations

import ast
import json
import math
import re
import statistics
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from portbench import bench, cost, trace
from portbench.traffic import Traffic, bin_lengths

torch.set_num_threads(1)

ROOT = bench.ROOT
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def _bench():
    return bench.load_benchmark()


def test_benchmark_keys_and_names():
    b = _bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert b["paths"] == ["portbench"]
    assert 1 <= b["run_seconds"] <= 51
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in b[k]]
    assert all(NAME.match(n) for n in names)
    assert len(set(x["name"] for x in b["end_to_end"] + b["per_layer"])) \
        == len(b["end_to_end"]) + len(b["per_layer"])
    for w in b["workloads"]:
        assert w["chips"] == 1 and len(w["why"]) <= 200
        assert NAME.match(w["traffic"])
    for m in b["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    assert any(m["name"] == "setup_s" for m in b["end_to_end"])
    e2e = {m["name"] for m in b["end_to_end"]}
    assert all(m["moves"] in e2e for m in b["per_layer"])


@pytest.mark.parametrize("cell", [w["name"] for w in
                                  bench.load_benchmark()["workloads"]])
def test_cell_found_by_name(cell):
    c = bench.find_cell(cell)
    assert c.traffic["kind"] in ("serve", "train")
    assert (bench.HERE / "drivers" / f"{c.traffic['kind']}.py").exists()
    assert (bench.HERE / "refs" / f"{c.config['reference']}.py").exists()
    assert c.limits
    names = {m["name"] for m in c.end_to_end}
    assert "setup_s" in names and len(names) >= 2 and c.per_layer
    for m in c.end_to_end + c.per_layer:
        assert callable(bench.reader(m["name"]))


def test_config_files_state_the_published_widths():
    qwen = json.loads((bench.HERE / "configs" / "qwen3-4b.json")
                      .read_text())
    assert (qwen["hidden_size"], qwen["intermediate_size"],
            qwen["num_hidden_layers"], qwen["num_attention_heads"],
            qwen["num_key_value_heads"], qwen["head_dim"],
            qwen["vocab_size"]) == (2560, 9728, 36, 32, 8, 128, 151936)
    assert qwen["tie_word_embeddings"] is True      # the published tie
    for c in _bench()["configs"]:
        f = json.loads((ROOT / c["file"]).read_text())
        assert set(c["reduced"]) == set(f["reduced"])


def test_unknown_cell_is_refused():
    with pytest.raises(KeyError):
        bench.find_cell("no-such-cell")


def test_traffic_is_deterministic_per_seed():
    spec = bench.find_cell("qwen3-4b.rerank").traffic
    a, b, c = (Traffic(spec, s, 151936) for s in (2 ** 33 + 5, 2 ** 33 + 5,
                                                  6))
    assert [a.prompt_len(i) for i in range(200)] == \
        [b.prompt_len(i) for i in range(200)]
    assert (a.prompt(17) == b.prompt(17)).all()
    assert not (a.prompt(17)[:64] == c.prompt(17)[:64]).all()


def test_every_seed_sends_the_same_lengths_in_another_order():
    spec = bench.find_cell("qwen3-4b.rerank").traffic
    k = spec["prompt"]["strata"]
    a, b = Traffic(spec, 1, 100), Traffic(spec, 2, 100)
    la = [a.prompt_len(i) for i in range(4 * k)]
    lb = [b.prompt_len(i) for i in range(4 * k)]
    assert la != lb
    for blk in range(4):
        assert sorted(la[blk * k:(blk + 1) * k]) == \
            sorted(lb[blk * k:(blk + 1) * k]) == sorted(bin_lengths(
                spec["prompt"]))


def test_lengths_follow_the_log_uniform_law():
    d = {"lo": 512, "hi": 4096, "strata": 64}
    xs = bin_lengths(d)
    assert min(xs) >= 512 and max(xs) <= 4096
    # log-uniform: the median at the geometric mean, the mean at
    # (hi - lo) / ln(hi / lo)
    assert abs(statistics.median(xs) - math.sqrt(512 * 4096)) < 30
    assert abs(statistics.mean(xs) - 3584 / math.log(8)) < 15


def _finished(n, rows, slots):
    return [{"uid": i, "prompt_len": 512 + (i * 37) % 3000,
             "row": i % rows, "slot": None if slots is None
             else 1 + (i * 13 // 5) % slots} for i in range(n)]


@pytest.mark.parametrize("rows, slots", [(16, None), (32, 32)])
def test_check_sample_covers_every_prefill_row(rows, slots):
    """The check's sample holds the longest request, one of each prefill
    row the window's first tokens came from, and at least the traffic's
    count; the same seed draws the same sample."""
    pick = bench.driver("serve").pick_sample
    done = _finished(400, rows, slots)
    for seed in (2 ** 31 + 3, 5, 6):
        got = pick(done, seed, 24)
        assert len(got) == max(24, rows)
        assert {q["row"] for q in got} == set(range(rows))
        assert max(done, key=lambda q: q["prompt_len"]) in got
        assert [q["uid"] for q in got] == sorted(q["uid"] for q in got)
        assert got == pick(done, seed, 24)
    assert pick(done, 5, 24) != pick(done, 6, 24)
    if slots is not None:      # a row's pick prefers a slot not yet held
        held = [len({q["slot"] for q in pick(done, s, 24)}) for s in (5, 6)]
        assert min(held) >= 28, held


def test_training_batches_differ_by_step_and_shift():
    spec = bench.find_cell("qwen3-4b.train-2k").traffic
    tr = Traffic(spec, 9, 151936)
    cpu = torch.device("cpu")
    (t0, l0), (t1, _) = tr.batch(0, cpu), tr.batch(1, cpu)
    assert t0.shape == (2, 2048) and (t0[:, 1:] == l0[:, :-1]).all()
    assert not (t0 == t1).all()
    assert (Traffic(spec, 9, 151936).batch(0, cpu)[0] == t0).all()


def _serve_run(**over):
    reqs = [{"uid": 0, "prompt_len": 600, "queued": 0.0, "first_token": 1.5},
            {"uid": 1, "prompt_len": 800, "queued": 1.0, "first_token": 3.0},
            {"uid": 2, "prompt_len": 900, "queued": 2.0, "first_token": 9.0},
            {"uid": 3, "prompt_len": 512, "queued": 0.5, "first_token": None}]
    run = {"kind": "serve", "t0": 1.0, "t1": 5.0, "window_s": 4.0,
           "setup_s": 12.5, "requests": reqs,
           "counters": {"prefill_tokens": 8000.0, "prefill_steps": 2,
                        "decode_steps": 0, "steps": 4,
                        "step_seconds": 3.2},
           "engine": {"prefill_batch": 2, "prefill_chunk": 4096,
                      "max_batch": 2, "page_size": 16, "max_len": 1024},
           "sizes": {"layers": 2, "d": 8, "hq": 2, "hkv": 1, "hd": 4,
                     "ff": 16, "vocab": 10, "attn": "full"}}
    run.update(over)
    return run


def test_rate_is_all_the_work_over_all_the_window():
    assert bench.reader("serve_tok_s")(_serve_run()) == 2000.0
    assert bench.reader("step_ms.serve")(_serve_run()) == \
        pytest.approx(800.0)
    assert bench.reader("prefill_fill.serve")(_serve_run()) == \
        pytest.approx(100.0 * 8000 / (2 * 2 * 4096))


def test_tail_is_over_every_request_of_the_window():
    # first tokens at 1.5 and 3.0 fall in [1, 5]: ttfts 1.5 and 2.0
    assert bench.reader("ttft_p90_s")(_serve_run()) == pytest.approx(1.95)
    assert bench.quantile([1, 2, 3, 4, 5, 6, 7, 8, 9, 10], 0.9) == \
        pytest.approx(9.1)
    assert bench.reader("train_tok_s")(_serve_run()) is None


def test_idle_share_is_the_union_of_device_intervals():
    dev = [("a", 0.0, 1.0), ("b", 0.5, 1.5), ("c", 3.0, 4.0)]
    host = [("aten::mm", 1.4, 2.9), ("cudaLaunchKernel", 2.0, 2.1)]
    s = trace.reduce(dev, host, 5.0)
    assert s["busy_s"] == pytest.approx(2.5)
    assert dict(s["device_ops"]) == {"a": 1.0, "b": 1.0, "c": 1.0}
    # the gap 1.5..3.0: its middle (2.25) lies in aten::mm only
    assert s["idle_gaps"] == [["aten::mm", 1.5]]
    run = _serve_run(trace_summary=s)
    assert bench.reader("idle_share.serve")(run) == pytest.approx(50.0)


def test_gather_roofline_counts_distinct_pages():
    page, width = 16, 64
    dev = [("paged_gather_kernel<uint4>", 0.0, 1e-3),
           ("paged_gather_kernel<uint4>", 1e-3, 2e-3),
           ("paged_gather_kernel<uint4>", 2e-3, 3e-3),
           ("paged_gather_kernel<uint4>", 3e-3, 4e-3)]
    spans = [{"name": "prefill_chunk", "t": 1.1, "t1": 1.1, "uid": 0,
              "tokens": 600},
             {"name": "prefill_step", "t": 1.0, "t1": 2.0, "uid": None},
             {"name": "prefill_chunk", "t": 2.1, "t1": 2.1, "uid": 1,
              "tokens": 800},
             {"name": "prefill_chunk", "t": 2.2, "t1": 2.2, "uid": 2,
              "tokens": 900},
             {"name": "prefill_step", "t": 2.0, "t1": 3.0, "uid": None}]
    run = _serve_run(trace=(dev, []), spans=spans)
    d = 4
    want = 0.0
    for pages in (38, 50 + 57):     # ceil(600/16); ceil(800/16) + ceil(900/16)
        byts = 2 * (2 * width * page + (pages + 1) * page) * d * 2
        want += 2 * max(0.0, byts / cost.PEAK_BYTES_S)
    got = bench.reader("gather_roofline.serve")(run)
    assert got == pytest.approx(100.0 * want / 4e-3)
    # a launch missing from the trace: nothing is read
    run = _serve_run(trace=(dev[:3], []), spans=spans)
    assert bench.reader("gather_roofline.serve")(run) is None


def test_mfu_counts_valid_tokens_and_the_head_once():
    spans = [{"name": "prefill_chunk", "t": 0.5, "t1": 0.5, "uid": 0,
              "tokens": 500},
             {"name": "prefill_chunk", "t": 2.0, "t1": 2.0, "uid": 0,
              "tokens": 100}]
    run = _serve_run(spans=spans)
    s = run["sizes"]
    want = sum(cost.token_flops(s, p) for p in range(500, 600)) \
        + cost.head_flops(s)
    got = bench.reader("mfu.serve")(run)
    assert got == pytest.approx(100.0 * want / 4.0 / cost.PEAK_BF16_FLOPS)


def test_frozen_cost_copy_equals_the_programs():
    from repro_torch.kernels import cost as prog
    # the cells' shapes: a K-and-V gather of 16 and of 32 rows x 257
    # pages x 16, D 1024, bf16; the SRF cell's spinner launches
    for rows in (16 * 257 * 16, 32 * 257 * 16):
        assert cost.gather(rows, 1024, 2) == prog.gather(rows, 1024, 2)
    for b in (32 * 4 * 512, 32 * 512, 16 * 4 * 512):
        assert cost.spinner("circulant", 8, b, 128, 256, 2, 256, 256) == \
            pytest.approx(prog.spinner("circulant", 8, b, 128, 256, 2, 256,
                                       256))
        assert cost.gen_elems("circulant", 128, 256) == \
            prog.gen_elems("circulant", 128, 256)


def _imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module.split(".")[0]


def test_sources_name_no_jax_and_the_references_no_program():
    files = [p for p in bench.HERE.rglob("*.py") if "tests" not in p.parts]
    for p in files:
        assert not set(_imports(p)) & set(bench.FORBIDDEN), p
    for p in (bench.HERE / "refs").glob("*.py"):
        assert not set(_imports(p)) & {"repro_torch", "portbench"}, p


def test_a_run_loads_no_jax_module():
    """Every module a run loads (the entry, both drivers, the
    references, every reader, the trace reduction): no top-level name
    of JAX or of the JAX package, compared whole; and the reference
    alone loads nothing of the program."""
    code = (
        "import sys, runpy; sys.path[:0] = ['.', 'src']\n"
        "from portbench import bench, trace\n"
        "ref = bench.reference('dense_lm')\n"
        "assert not [m for m in sys.modules if m.split('.')[0] == "
        "'repro_torch'], 'the reference loaded the program'\n"
        "runpy.run_path('portbench/run.py', run_name='portbench_run')\n"
        "for k in ('serve', 'train'): bench.driver(k)\n"
        "for m in bench.load_benchmark()['end_to_end'] + "
        "bench.load_benchmark()['per_layer']: bench.reader(m['name'])\n"
        "bad = bench.forbidden_modules()\n"
        "assert [m for m in sys.modules if m.split('.')[0] == "
        "'repro_torch'], 'the drivers did not load the program'\n"
        "print(bad); sys.exit(bool(bad))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr
    assert bench.forbidden_modules({"repro_torch": 0, "repro_torch.x": 0,
                                    "jaxtyping": 0}) == []
    assert bench.forbidden_modules({"repro.models": 0, "jax": 0}) == \
        ["jax", "repro.models"]


def test_without_the_program_a_run_prints_no_result(tmp_path):
    """In a directory holding only BENCHMARK.json and portbench/, a run
    exits non-zero with no result line."""
    import shutil
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(bench.HERE, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", "qwen3-4b.rerank",
         "--seed", "1", "--seconds", "1"], cwd=tmp_path,
        capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert '"correct"' not in out.stdout
