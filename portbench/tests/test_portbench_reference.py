"""The plain references against the port on the CPU, at the cells'
shapes cut to a test's size in float32: a run of each cell's driver,
its timed path through the port, compares equal to rounding."""
from __future__ import annotations

import time

import pytest
import torch

from portbench import bench
from portbench.tests.cells import tiny

torch.set_num_threads(1)

CPU = torch.device("cpu")


@pytest.mark.parametrize("name", ["qwen3-4b.rerank", "qwen3-4b-srf.rerank"])
@pytest.mark.parametrize("trace", [False, True])
def test_serving_run_matches_the_reference(name, trace):
    cell = tiny(name)
    rec = bench.driver("serve").run(cell, 2 ** 31 + 11, 0.4, trace, CPU,
                                    time.perf_counter())
    assert rec["attempted"] > 0 and rec["failed"] == 0
    assert rec["check"]["token_gap"] < 1e-4
    assert rec["check"]["logit_err"] < 1e-4
    res = bench.result(cell, rec, trace, {"platform": "cpu"})
    assert res.correct
    want = {m["name"] for m in (cell.per_layer if trace
                                else cell.end_to_end)}
    # the kernel rooflines read nothing without a card's trace
    assert set(res.metrics) == want - {"gather_roofline.serve",
                                       "spinner_roofline.serve"}
    assert list(res.line().rstrip("}").split('"check"'))[-1]


def test_training_run_matches_the_reference():
    cell = tiny("qwen3-4b.train-2k")
    rec = bench.driver("train").run(cell, 5, 0.4, False, CPU,
                                    time.perf_counter())
    assert rec["steps"] > 0 and rec["failed"] == 0
    for k, v in rec["check"].items():
        assert v < 1e-5, (k, v)
    assert bench.result(cell, rec, False, {"platform": "cpu"}).correct


def test_reference_srf_projection_is_the_ports():
    """The reference's dense SRF projection A D1 H D0 equals the port's
    materialized spinner block on the same generator and diagonals."""
    from repro_torch.core import spinner
    ref = bench.reference("dense_lm")
    gen = torch.Generator().manual_seed(3)
    blk = spinner.SpinnerBlock("circulant", 64, 32)
    p = blk.init(gen)
    want = blk.materialize(p)
    got = ref.srf_projection(p["g"], p["d0"], p["d1"], 64)
    assert torch.allclose(got, want, atol=1e-5)


@pytest.mark.parametrize("is_query", [True, False])
def test_reference_srf_features_are_the_ports(is_query):
    """The reference's features of a layer's heads equal the port's
    ``srf_attention.feature_map`` (the spinner's plain route) on the same
    params, queries grouped onto their kv head."""
    from repro_torch.configs.base import ModelConfig, SRFAttnConfig
    from repro_torch.core import srf_attention as srf
    from repro_torch.models import attention
    ref = bench.reference("dense_lm")
    cfg = ModelConfig(name="t", family="dense", n_layers=1, d_model=64,
                      n_heads=4, n_kv_heads=2, head_dim=16, d_ff=32,
                      vocab=50, attn_impl="srf",
                      srf=SRFAttnConfig(n_features=32))
    sc = attention.srf_cfg(cfg)
    p = srf.init(torch.Generator().manual_seed(1), sc, 2)
    x = torch.randn(1, 2, 2 * 7, 16, generator=torch.Generator()
                    .manual_seed(2))
    want = srf.feature_map(sc, p, x, is_query=is_query)[0]
    w = torch.stack([ref.srf_projection(p[0]["g"][k], p[0]["d0"][k],
                                        p[0]["d1"][k], 32) for k in range(2)])
    got = ref.srf_features(x[0], w, is_query, None)
    assert torch.allclose(got, want, rtol=1e-4, atol=1e-7)


def test_reference_tied_head_is_the_ports():
    """Served logits against the reference with the head tied to the
    embedding, as the published Qwen3-4B and the cells have it (the
    tests' small cells untie it: tests/cells.py)."""
    cell = tiny("qwen3-4b.rerank")
    cell.config["tie_word_embeddings"] = True
    ref = bench.reference("dense_lm")
    assert "head" not in ref.make_weights(cell.config, 3, CPU)
    rec = bench.driver("serve").run(cell, 3, 0.3, False, CPU,
                                    time.perf_counter())
    assert rec["attempted"] > 0 and rec["failed"] == 0
    assert rec["check"]["logit_err"] < 1e-4


def test_page_pool_holds_every_slot_at_max_len():
    """The full-attention engine's pool is the pages that every slot
    filled to ``max_len`` takes, and the null page: no more."""
    cell = tiny("qwen3-4b.rerank")
    ref = bench.reference("dense_lm")
    e = cell.traffic["engine"]
    engine = bench.driver("serve").engine_for(
        cell, ref.make_weights(cell.config, 1, CPU), CPU)
    width = -(-e["max_len"] // e["page_size"])
    assert engine.sched_cfg.num_pages == e["slots"] * width + 1
    assert engine.sched_cfg.table_width == width
