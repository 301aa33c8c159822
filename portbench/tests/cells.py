"""Cells of ``BENCHMARK.json`` cut to a size a CPU test run holds: every
width small, float32, a few layers; the traffic's shape kept. The head
is untied, so the logits keep the full model's scale (N(0, 1/d) head
weights): a tied head's logits scale with 0.02 sqrt(d), 0.16 at d = 64
against 1.01 at the published 2560, under which the cells' limits
would pass a wrong token. The tied head has its own test."""
from __future__ import annotations

import copy

from portbench import bench

TINY = {"hidden_size": 64, "intermediate_size": 96, "num_hidden_layers": 2,
        "num_attention_heads": 4, "num_key_value_heads": 2, "head_dim": 16,
        "vocab_size": 300, "torch_dtype": "float32",
        "tie_word_embeddings": False}


def tiny(name: str) -> bench.Cell:
    cell = bench.find_cell(name)
    c = dict(copy.deepcopy(cell.config), **TINY)
    srf = c["port"].get("srf")
    if srf:
        srf.update(n_features=32, chunk=8)
    t = copy.deepcopy(cell.traffic)
    if t["kind"] == "serve":
        n = 4
        t["prompt"].update(lo=8, hi=64, strata=8)
        t["arrivals"]["clients"] = n
        t["engine"].update(slots=n, max_batch=n, prefill_batch=n,
                           prefill_chunk=16, max_len=80)
        t["check"]["requests"] = 4
        t["warmup_steps"] = 1
    else:
        t["train"] = {"batch": 2, "seq": 32}
    cell.config, cell.traffic = c, t
    return cell
