"""Training steps of the port: ``launch/steps.make_grad_step`` (the
loss, ``torch.autograd.grad``) then ``optim/adamw.update`` (f32 moments,
in place), at a constant learning rate.

Set-up makes the weights from the seed on the card, builds the one
training state (params, moments, the grad step) and drives it through
the traffic's ``check_steps`` first steps by the window's own call, on
rows that all differ: they warm every shape up and are what the
reference follows. It records each step's loss, the first gradient as
the optimizer got it (worked out from the first moment after one step:
mu / (1 - b1)) and, after the last of them, each leaf's change from the
seed's weights (made again leaf by leaf). The window then runs steps of
the same state for ``--seconds`` (the host queues steps ahead: nothing
in a step waits for the device; the losses are read after the window)
and closes when the steps launched before it crossed have ended.

After the window the state is freed and the plain reference trains the
same weights on the same first batches in float32 (``refs/``). Three
numbers are compared, each by the worst leaf where it is a norm: the
gap between the two norms over the reference's norm of the leaf or of
the median leaf, whichever is larger; leaves whose reference gradient is
under a thousandth of the median leaf's are left out:

* ``loss_gap``: the largest gap between the two losses of a step;
* ``grad_gap``: the first gradient's norms;
* ``change_gap``: the change's norms after the check steps.
"""
from __future__ import annotations

import gc
import statistics
import time
from typing import Dict, List

import torch

from portbench import bench
from portbench.port import model_config
from portbench.traffic import Traffic
from repro_torch import tree as tree_lib
from repro_torch.launch import steps as step_lib
from repro_torch.optim import adamw


def _name(path) -> str:
    return "/".join(map(str, path))


@torch.no_grad()
def _norm(t: torch.Tensor, minus=None) -> float:
    t = t.float()
    return float(torch.linalg.vector_norm(t if minus is None
                                          else t - minus.float()))


class Trainer:
    """The one training state and its step."""

    def __init__(self, cell: bench.Cell, params, device):
        cfg = model_config(cell.config)
        for t in tree_lib.leaves(params):
            if t.is_floating_point():
                t.requires_grad_(True)
        self.params = params
        self.state = adamw.init(params)
        self.grad_step = step_lib.make_grad_step(cfg)
        self.adam = adamw.AdamWConfig()
        self.update = adamw.update
        self.lr = torch.tensor(float(cell.traffic["lr"]),
                               dtype=torch.float32, device=device)
        self.adamw_ms: List = []
        self.time_adamw = False

    def step(self, tokens, labels) -> torch.Tensor:
        """One step; its loss stays on the device (reading it would wait
        for the step)."""
        grads, m = self.grad_step(self.params, {"tokens": tokens,
                                                "labels": labels})
        if self.time_adamw:
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record()
        self.params, self.state, _ = self.update(grads, self.state,
                                                 self.params, self.lr,
                                                 self.adam)
        if self.time_adamw:
            ev[1].record()
            self.adamw_ms.append(ev)
        return m["loss"]


def run(cell: bench.Cell, seed: int, seconds: float, trace: bool,
        device, t_process: float, on_window=None) -> Dict:
    """One run of a training cell -> the run record. ``on_window(trainer)``
    (tests) may break the step before the check steps run."""
    marks = [("imports", time.perf_counter())]
    ref = bench.reference(cell.config["reference"])
    s = ref.sizes(cell.config)
    traffic = Traffic(cell.traffic, seed, s["vocab"])
    trainer = Trainer(cell, ref.make_weights(cell.config, seed, device),
                      device)
    _sync(device)
    marks.append(("weights and state", time.perf_counter()))
    if on_window is not None:
        on_window(trainer)
    specs = ref.leaf_specs(s)
    n_check = int(cell.traffic["check_steps"])
    prog: Dict = {"loss": [], "grad": {}, "change": {}}
    for i in range(n_check):
        prog["loss"].append(float(trainer.step(*traffic.batch(i, device))))
        if i == 0:
            prog["grad"] = {_name(p): _norm(ref.get(trainer.state["mu"], p))
                            / (1 - trainer.adam.b1) for p, *_r in specs}
    _sync(device)
    marks.append(("check steps", time.perf_counter()))
    for i, (p, *_r) in enumerate(specs):
        prog["change"][_name(p)] = _norm(
            ref.get(trainer.params, p), ref.make_leaf(s, seed, i, device))
    prof = None
    if trace:
        trainer.time_adamw = torch.device(device).type == "cuda"
        prof = torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA])
        prof.start()
    _sync(device)
    t0 = time.perf_counter()
    losses = []
    while time.perf_counter() - t0 < seconds:
        losses.append(trainer.step(*traffic.batch(n_check + len(losses),
                                                  device)))
    _sync(device)
    t1 = time.perf_counter()
    losses = [float(x) for x in losses]
    if prof is not None:
        prof.stop()
    peak = torch.cuda.max_memory_allocated(device) \
        if torch.device(device).type == "cuda" else 0
    t = cell.traffic["train"]
    record = {"kind": "train", "cell": cell.name, "sizes": s,
              "batch": int(t["batch"]), "seq": int(t["seq"]),
              "tokens_per_step": int(t["batch"]) * int(t["seq"]),
              "t0": t0, "t1": t1, "window_s": t1 - t0,
              "setup_s": t0 - t_process, "steps": len(losses),
              "setup_phases": bench.phases(t_process,
                                     marks + [("change norms", t0)]),
              "memory_peak_bytes": int(peak), "attempted": len(losses),
              "failed": sum(1 for x in losses if x != x
                            or abs(x) == float("inf")),
              "adamw_ms": [a.elapsed_time(b) for a, b in trainer.adamw_ms]}
    if prof is not None:
        from portbench import trace as trace_lib
        record["trace"] = trace_lib.events(prof)
        del prof
    del trainer
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    got = ref.train_reference(cell.config, seed,
                              [traffic.batch(i, device)
                               for i in range(n_check)],
                              float(cell.traffic["lr"]), _adam(), device)
    record["check"] = compare(prog, got)
    return record


def _adam() -> Dict:
    a = adamw.AdamWConfig()
    return {"b1": a.b1, "b2": a.b2, "eps": a.eps,
            "weight_decay": a.weight_decay, "clip_norm": a.clip_norm}


def compare(prog: Dict, ref: Dict) -> Dict[str, float]:
    """The three compared numbers of a program's and a reference's
    readings (module docstring)."""
    med_g = statistics.median(ref["grad"].values())
    live = [k for k, v in ref["grad"].items() if v >= 1e-3 * med_g]

    def worst(key):
        med = statistics.median(ref[key][k] for k in live)
        return max(abs(prog[key][k] - ref[key][k]) / max(ref[key][k], med)
                   for k in live)
    return {"loss_gap": max(abs(a - b) for a, b in zip(prog["loss"],
                                                       ref["loss"])),
            "grad_gap": worst("grad"), "change_gap": worst("change")}


def control(cell: bench.Cell, seed: int, device, quant: str = "fp8"
            ) -> Dict[str, float]:
    """The check's numbers with the reference at ``quant`` put in the
    program's place; and, planted in the reference put in its place,
    half of each batch left out (the mean over the rest)."""
    ref = bench.reference(cell.config["reference"])
    s = ref.sizes(cell.config)
    traffic = Traffic(cell.traffic, seed, s["vocab"])
    n = int(cell.traffic["check_steps"])
    batches = [traffic.batch(i, device) for i in range(n)]
    lr = float(cell.traffic["lr"])
    base = ref.train_reference(cell.config, seed, batches, lr, _adam(),
                               device)
    torch.cuda.empty_cache()
    low = ref.train_reference(cell.config, seed, batches, lr, _adam(),
                              device, quant=quant)
    torch.cuda.empty_cache()
    half = ref.train_reference(cell.config, seed,
                               [(t[: len(t) // 2], lb[: len(lb) // 2])
                                for t, lb in batches], lr, _adam(), device)
    return {**{f"{quant}.{k}": v for k, v in compare(low, base).items()},
            **{f"half_batch.{k}": v for k, v in compare(half, base).items()}}


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)
