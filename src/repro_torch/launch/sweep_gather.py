"""Time the int8 paged gather (``paged_gather_dequant``, int8 -> bf16)
under other launch plans than ``paged_gather.dequant_plan`` picks, on the
card, and print one JSON line per plan.

    python src/repro_torch/launch/sweep_gather.py \
        [--set STAGE_MIN=2048,BLOCKS_PER_SM=4] [--set path=vector] ...

Each ``--set`` is one plan: module constants of ``kernels.paged_gather``
(``STAGE_MAX``, ``STAGE_MIN``, ``STAGES``, ``BLOCKS_PER_SM``,
``CONSUMERS``) and the ``path`` of the ``DequantPlan`` it returns (a
"vector" or "scalar" path in place of "tma" on aligned pools),
comma-separated; with no ``--set`` only the default
plan is timed, and it is always timed first. Shapes and times as
``launch/time_kernels.py``: decode (R = 8, M = 16) and prefill (R = 32,
M = 64), P = 16, D = 1024, 36 layers' pools cycled, one pool a call and a
layer's K and V in one launch; CUDA events over 100 launches, median of
5. Every plan's output is first checked bit for bit against the plain
version on one layer.
"""
from __future__ import annotations

import argparse
import dataclasses
import itertools
import json
import subprocess
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

from repro_torch.launch.time_kernels import (GATHER, GATHER_D,  # noqa: E402
                                             GATHER_P, LAYERS, device_ms)

CONSTANTS = ("STAGE_MAX", "STAGE_MIN", "STAGES", "BLOCKS_PER_SM",
             "CONSUMERS")
FIELDS = ("path",)


def parse(spec: str):
    """'A=1,path=vector' -> ({constant: int}, {plan field: value})."""
    consts, fields = {}, {}
    for item in filter(None, spec.split(",")):
        key, _, val = item.partition("=")
        if key in CONSTANTS:
            consts[key] = int(val)
        elif key in FIELDS:
            fields[key] = val
        else:
            raise SystemExit(f"sweep_gather: unknown key {key!r} (constants "
                             f"{CONSTANTS}, plan fields {FIELDS})")
    return consts, fields


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--set", action="append", default=[], dest="plans")
    args = ap.parse_args()
    plans = [""] + args.plans
    specs = [parse(p) for p in plans]
    import torch
    if not torch.cuda.is_available():
        print("sweep_gather: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.kernels import build, ref
    from repro_torch.kernels import paged_gather as kpg
    build.build(["paged_gather"])
    default_plan = kpg.dequant_plan
    defaults = {k: getattr(kpg, k) for k in CONSTANTS}
    gen = torch.Generator(device="cuda").manual_seed(0)
    shapes = []
    for label, n, r, m in GATHER:
        tables = torch.randint(1, n, (r, m), generator=gen, device="cuda")
        layers = [[(torch.randint(-127, 128, (n, GATHER_P, GATHER_D),
                                  generator=gen, device="cuda",
                                  dtype=torch.int8),
                    torch.rand((n, GATHER_P, 1), generator=gen,
                               device="cuda") / 127) for _ in range(2)]
                  for _ in range(LAYERS)]
        shapes.append((label, tables, layers))
    bf = torch.bfloat16
    for spec, (consts, fields) in zip(plans, specs):
        for key, val in {**defaults, **consts}.items():
            setattr(kpg, key, val)
        kpg.dequant_plan = (lambda *a, f=fields, **k: dataclasses.replace(
            default_plan(*a, **k), **f))
        res = {}
        for label, tables, layers in shapes:
            (kq, ks), (vq, vs) = layers[0]
            k, v = kpg.paged_gather_dequant_kv_cuda(kq, ks, vq, vs, tables,
                                                    bf)
            if not (torch.equal(k, ref.paged_gather_dequant_ref(
                    kq, ks, tables, bf)) and torch.equal(
                    v, ref.paged_gather_dequant_ref(vq, vs, tables, bf))):
                raise AssertionError(f"plan {spec!r}: {label} output "
                                     f"differs from the plain version")
            plan = kpg.dequant_plan(GATHER_P, GATHER_D, 1, tables.numel(),
                                    0, 0, bf, n_pages=layers[0][0][0].shape[0],
                                    sms=kpg._sms(0))
            it = itertools.cycle(layers)
            res[label] = {
                "plan": dataclasses.asdict(plan),
                "one pool": device_ms(torch, lambda: kpg.
                                      paged_gather_dequant_cuda(
                                          *next(it)[0], tables, bf), 100, 5),
                "K and V": device_ms(torch, lambda: kpg.
                                     paged_gather_dequant_kv_cuda(
                                         *itertools.chain(*next(it)),
                                         tables, bf), 100, 5)}
        kpg.dequant_plan = default_plan
        print(json.dumps({"set": spec or "default", "ms": res}), flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(json.dumps({"card": smi}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
