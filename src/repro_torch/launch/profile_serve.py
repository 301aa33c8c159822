"""Where the serving time goes on the card: one traced run of the port's
engine under ``torch.profiler``.

    PYTHONPATH=src python -m repro_torch.launch.profile_serve \
        --arch qwen3-4b --attn srf --requests 8 --prompt-len 128 \
        --max-new 32 --max-len 256

Takes ``launch.serve``'s flags as they are. Builds the model they name
(full width unless ``--reduced``; random weights from ``--seed``),
serves a short warm-up (``serve.warm``), then serves the requests once
untraced and once with the profiler on, and prints:

* host time per engine step, prefill and decode apart, from the
  untraced run;
* the traced run's wall time and the device's busy share (the sum of
  device kernel and copy time over the wall time of the traced run —
  the profiler's own host cost inflates the wall time, so the share is
  a lower bound);
* device time by kernel name, the ``TOP`` largest.

Requires a CUDA device; there is no CPU fallback.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from typing import List, Optional

import torch

from repro_torch.launch import serve

TOP = 15                            # kernel rows printed


def _device_us(evt) -> float:
    for name in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, name):
            return float(getattr(evt, name))
    return 0.0


def main(argv: Optional[List[str]] = None) -> int:
    args = serve.parser().parse_args(argv)
    if not torch.cuda.is_available() or args.device != "cuda":
        print("profile_serve: needs a CUDA device (--device cuda)",
              file=sys.stderr)
        return 1
    cfg, params = serve.build(args)
    serve.warm(args, cfg, params)

    # untraced run: host time per step, by step kind
    res = serve.serve(args, cfg, params)
    eng = res["engine"]
    steps = eng.metrics.histogram("engine_step_seconds", "",
                                  ("engine",)).labels(
                                      engine=eng.engine_id).values()
    n_pre = int(eng.stats["prefill_steps"])
    print(json.dumps({
        "untraced": {"wall_s": res["wall_s"], "tok_s": res["tok_s"],
                     "ttft_p50_s": res["ttft_s"]["p50"],
                     "prefill_steps": n_pre,
                     "decode_steps": int(eng.stats["decode_steps"]),
                     "prefill_step_ms_median":
                         1e3 * statistics.median(steps[:n_pre]),
                     "decode_step_ms_median":
                         1e3 * statistics.median(steps[n_pre:])}}))

    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        traced = serve.serve(args, cfg, params)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    # device-side rows only (kernels, copies): an operator row also
    # carries the device time of the kernels it launched
    cuda = torch.autograd.DeviceType.CUDA
    rows = [(e.key, _device_us(e), e.count) for e in prof.key_averages()
            if getattr(e, "device_type", None) == cuda]
    rows = [r for r in rows if r[1] > 0]
    busy_us = sum(r[1] for r in rows)
    rows.sort(key=lambda r: -r[1])
    print(json.dumps({"traced": {
        "wall_s": wall, "tok_s": traced["tok_s"],
        "device_busy_s": busy_us / 1e6,
        "device_busy_share": busy_us / 1e6 / wall,
        "top_device": [{"name": k[:80], "ms": us / 1e3, "calls": c}
                       for k, us, c in rows[:TOP]]}}))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0])
    return 0


if __name__ == "__main__":
    sys.exit(main())
