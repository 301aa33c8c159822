"""Where the training time goes on the card: steps of the port's train
step, timed by parts, then one traced under ``torch.profiler``.

    PYTHONPATH=src python -m repro_torch.launch.profile_train \
        --arch qwen3-4b [--attn srf] [--reduced] [--steps 3] \
        [--batch 8 --seq 64 --seed 0]

Builds the model the flags name (full width unless ``--reduced``;
random weights from ``--seed``), takes one warm-up step, then
``--steps`` steps untraced, each split by CUDA events into the
forward-and-backward (``launch.steps.make_grad_step``) and the AdamW
update, and one step traced. Prints one JSON object a part:

* ``untraced``: the step's ms, training tokens/s and bf16-peak share as
  :func:`timed` and :func:`step_rates` define them (``chip_smoke.py``
  phase 5 reads a step through the same two), the device time of its two
  parts (medians), and peak device memory;
* ``traced``: the device's busy share over the traced step (kernels and
  copies over wall time; the profiler's own host cost inflates the wall,
  so the share is a lower bound), device time by kernel (the ``TOP``
  largest), the spinner kernels' device time and launches, and for the
  spinner backward's ``record_function`` ranges
  (``spinner_project_bwd``, ``spinner_project_seeded_bwd``: the plain
  VJPs the autograd Functions run) the device time of the kernels
  launched inside them (``kernel_ms``) and their span on the device's
  timeline, idle time included (``span_on_device_ms``).

Requires a CUDA device; there is no CPU fallback.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from typing import List, Optional

import torch

from repro_torch.configs import registry
from repro_torch.data import synth
from repro_torch.data.loader import device_batch
from repro_torch.launch import steps
from repro_torch.launch.profile_serve import _device_us
from repro_torch.models import transformer as model_lib
from repro_torch.optim import adamw, schedule

TOP = 15
PEAK_BF16_FLOP_PER_S = 989e12     # H100 SXM bf16 dense (data sheet)
SPINNER_KERNELS = ("spinner_kernel", "seeded_spinner_kernel")
SPINNER_BWD = ("spinner_project_bwd", "spinner_project_seeded_bwd")


def timed(fn, *args):
    """``(fn(*args), seconds)``: host clock, the device synced before
    and after. The one definition of a training step's time."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn(*args)
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def step_rates(cfg, batch: int, seq: int, step_s: float) -> dict:
    """Step ms, training tokens/s, and the share of the card's bf16 dense
    peak that 6·N·tokens a step reaches. N is
    ``cfg.active_param_count()``, the params a token passes through: an
    MoE config's routed top-k and shared experts, not all of them; for
    any other config it equals ``cfg.param_count()``. The recompute's
    extra forward is not counted."""
    tokens = batch * seq
    return {"step_ms": 1e3 * step_s, "tokens_s": tokens / step_s,
            "bf16_peak_share": 6 * cfg.active_param_count() * tokens
            / step_s / PEAK_BF16_FLOP_PER_S}


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", required=True, choices=registry.ARCHS)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--attn", default=None, choices=["full", "srf"])
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_train: needs a CUDA device", file=sys.stderr)
        return 1
    over = {"attn_impl": args.attn} if args.attn else {}
    cfg = (registry.reduced if args.reduced else registry.get)(args.arch,
                                                               **over)
    params = model_lib.requires_grad(model_lib.init(cfg, seed=args.seed,
                                                    device="cuda"))
    state = adamw.init(params)
    hyper = steps.TrainHyper()
    grad_step = steps.make_grad_step(cfg, hyper.aux_weight)

    def step(i):
        batch = device_batch(synth.full_batch(cfg, args.batch, args.seq, i,
                                              seed=args.seed), "cuda")
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]

        def run():
            ev[0].record()
            grads, m = grad_step(params, batch)
            ev[1].record()
            lr = schedule.warmup_cosine(i, hyper.lr, hyper.warmup,
                                        hyper.total_steps, device="cuda")
            adamw.update(grads, state, params, lr, hyper.adam)
            ev[2].record()
            return m
        m, s = timed(run)
        return (s, ev[0].elapsed_time(ev[1]), ev[1].elapsed_time(ev[2]),
                float(m["loss"]))

    step(0)
    torch.cuda.reset_peak_memory_stats()
    parts = [step(1 + i) for i in range(args.steps)]
    print(json.dumps({"untraced": {
        "arch": cfg.name, "attn": cfg.attn_impl, "n_layers": cfg.n_layers,
        "remat": cfg.remat, "batch": args.batch, "seq": args.seq,
        **step_rates(cfg, args.batch, args.seq,
                     statistics.median(p[0] for p in parts)),
        "fwd_bwd_device_ms": statistics.median(p[1] for p in parts),
        "adamw_device_ms": statistics.median(p[2] for p in parts),
        "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
        "losses": [p[3] for p in parts]}}))

    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        _, wall = timed(step, 1 + args.steps)
    cuda = torch.autograd.DeviceType.CUDA
    evts = prof.key_averages()
    # device rows: kernels and copies; the spinner backward's ranges also
    # appear on the device's timeline (their spans, idle time included),
    # and are no kernel
    rows = [(e.key, _device_us(e), e.count) for e in evts
            if getattr(e, "device_type", None) == cuda
            and e.key not in SPINNER_BWD]
    rows = [r for r in rows if r[1] > 0]
    busy_us = sum(r[1] for r in rows)
    rows.sort(key=lambda r: -r[1])
    bwd = []
    for e in evts:
        if e.key not in SPINNER_BWD:
            continue
        on_card = getattr(e, "device_type", None) == cuda
        bwd.append({"range": e.key, "calls": e.count,
                    ("span_on_device_ms" if on_card else "kernel_ms"):
                    _device_us(e, total=not on_card) / 1e3})
    print(json.dumps({"traced": {
        "wall_ms": 1e3 * wall, "device_busy_ms": busy_us / 1e3,
        "device_busy_share": busy_us / 1e6 / wall,
        "top_device": [{"name": k[:80], "ms": us / 1e3, "calls": c}
                       for k, us, c in rows[:TOP]],
        "spinner_forward": [{"name": k[:80], "ms": us / 1e3, "calls": c}
                            for k, us, c in rows
                            if any(s in k for s in SPINNER_KERNELS)],
        "spinner_backward": bwd}}))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0])
    return 0


if __name__ == "__main__":
    sys.exit(main())
