"""A run with its timed path broken underneath comes out not correct:
for each fault a cell can have, on the CPU at a test's size, the
harness's look for a card skipped and the rest of a run driven. One
chip holds every cell, so no exchange between chips can be left out."""
from __future__ import annotations

import time

import pytest
import torch

from portbench import bench
from portbench.tests.cells import tiny
from repro_torch import tree as tree_lib

torch.set_num_threads(1)

CPU = torch.device("cpu")
SERVE = ["qwen3-4b.rerank", "qwen3-4b-srf.rerank"]


def _run(name, on_window):
    cell = tiny(name)
    rec = bench.driver(cell.traffic["kind"]).run(
        cell, 77, 0.4, False, CPU, time.perf_counter(), on_window=on_window)
    return bench.result(cell, rec, False, {"platform": "cpu"})


def _token_altered(engine):
    sample = engine._sample_rows

    def altered(rows, seqs):
        return (sample(rows, seqs) + 1) % engine.cfg.vocab
    engine._sample_rows = altered


def _state_unchanged(engine):
    step = engine._step

    def unchanged(params, pools, *args, **kw):
        live = [t for t in tree_lib.leaves(pools) if t is not None]
        keep = [t.clone() for t in live]
        logits, pools = step(params, pools, *args, **kw)
        for t, k in zip(live, keep):
            t.copy_(k)
        return logits, pools
    engine._step = unchanged


def _half_batch(engine):
    step = engine._step

    def half(params, pools, tokens, positions, q_valid, *args, **kw):
        q_valid = q_valid.clone()
        q_valid[q_valid.shape[0] // 2:] = False
        return step(params, pools, tokens, positions, q_valid, *args, **kw)
    engine._step = half


def _last_row_altered(engine):
    """A token altered in the last prefill row alone."""
    sample = engine._sample_rows

    def altered(rows, seqs):
        out = sample(rows, seqs)
        out[-1] = (out[-1] + 1) % engine.cfg.vocab
        return out
    engine._sample_rows = altered


@pytest.mark.parametrize("name", SERVE)
@pytest.mark.parametrize("fault", [_token_altered, _state_unchanged,
                                   _half_batch, _last_row_altered])
def test_serving_fault_is_not_correct(name, fault):
    res = _run(name, fault)
    assert not res.correct, res.check


def _train_state_unchanged(trainer):
    trainer.update = lambda grads, state, params, lr, cfg: (params, state,
                                                            {})


def _train_half_batch(trainer):
    real = trainer.grad_step

    def half(params, batch):
        n = batch["tokens"].shape[0] // 2
        return real(params, {k: v[:n] for k, v in batch.items()})
    trainer.grad_step = half


@pytest.mark.parametrize("fault", [_train_state_unchanged,
                                   _train_half_batch])
def test_training_fault_is_not_correct(fault):
    res = _run("qwen3-4b.train-2k", fault)
    assert not res.correct, res.check
