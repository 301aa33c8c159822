"""Time a paged gather under other launch plans than the default, on
the card, and print one JSON line per plan.

    python src/repro_torch/launch/sweep_gather.py [--kernel copy] \
        [--set STAGES=2,path=vector] [--set unit=8] ...

``--kernel dequant`` (the default): the int8 gather
(``paged_gather_dequant``, int8 -> bf16) under ``paged_gather.
dequant_plan``'s constants (``STAGE_MAX``, ``STAGE_MIN``, ``STAGES``,
``BLOCKS_PER_SM``, ``CONSUMERS``) and the ``path`` of the plan it
returns (a "vector" or "scalar" path in place of "tma" on aligned
pools). ``--kernel copy``: the bf16 gather (``paged_gather`` and
``paged_gather_kv``) under the ``unit`` of the plan
``paged_gather.gather_plan`` returns (8, 4, 2 or 1 bytes a load and a
store in place of 16 on aligned pools; its blocks are fixed in the
kernel).

Each ``--set`` is one plan, comma-separated; with no ``--set`` only the
default plan is timed, and it is always timed first. Shapes and times as
``launch/time_kernels.py``: decode (R = 8, M = 16) and prefill (R = 32,
M = 64), P = 16, D = 1024, 36 layers' pools cycled, one pool a call and a
layer's K and V in one launch; for the copy gather also the other
families' pairs at decode (``COPY_SHAPES``: deepseek's latents c, D =
512, and kpe, D = 64; hymba, D = 320; qwen2-vl, D = 256; moonshot, D =
2048) and the enc-dec memory pool (``MEMORY``: one 2 MiB page a request,
8 requests); CUDA events over 100 launches, median of 5. Every plan's output is first checked bit for bit
against the plain version on one layer.
"""
from __future__ import annotations

import argparse
import dataclasses
import importlib
import itertools
import json
import subprocess
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

from repro_torch.launch.time_kernels import (GATHER, GATHER_D,  # noqa: E402
                                             GATHER_P, LAYERS, device_ms)

CONSTANTS = {"dequant": ("STAGE_MAX", "STAGE_MIN", "STAGES",
                         "BLOCKS_PER_SM", "CONSUMERS"),
             "copy": ()}
FIELDS = {"dequant": ("path",), "copy": ("unit",)}
# the copy gather's other shapes at decode, R = 8, M = 16, N = 257:
# (label, P, row widths of the pair, layers); one pool: the first width
COPY_SHAPES = [("decode c+kpe", 16, (512, 64), 27),
               ("decode hymba", 16, (320, 320), 32),
               ("decode qwen2-vl", 16, (256, 256), 28),
               ("decode moonshot", 16, (2048, 2048), 48)]
# the enc-dec memory pool: 8 slots of one 2 MiB page (1024 x 1024)
MEMORY = ("memory", 9, 1024, 1024, 8)


def parse(spec: str, kernel: str):
    """'A=1,path=vector' -> ({constant: value}, {plan field: value})."""
    consts, fields = {}, {}
    for item in filter(None, spec.split(",")):
        key, _, val = item.partition("=")
        if key in CONSTANTS[kernel]:
            consts[key] = int(val) if val.isdigit() else val
        elif key in FIELDS[kernel]:
            fields[key] = int(val) if val.isdigit() else val
        else:
            raise SystemExit(f"sweep_gather: unknown key {key!r} (constants "
                             f"{CONSTANTS[kernel]}, plan fields "
                             f"{FIELDS[kernel]})")
    return consts, fields


def sweep_copy(torch, kpg, ref, plans, specs):
    """The copy gather's plans: one pool and two in one launch."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    bf = torch.bfloat16
    shapes = []
    for label, n, r, m in GATHER:
        tables = torch.randint(1, n, (r, m), generator=gen, device="cuda")
        layers = [[torch.randn((n, GATHER_P, GATHER_D), generator=gen,
                               device="cuda").to(bf) for _ in range(2)]
                  for _ in range(LAYERS)]
        shapes.append((label, tables, layers))
    for label, p, widths, nl in COPY_SHAPES:
        tables = torch.randint(1, 257, (8, 16), generator=gen, device="cuda")
        shapes.append((label, tables, [
            [torch.randn((257, p, d), generator=gen, device="cuda").to(bf)
             for d in widths] for _ in range(nl)]))
    label, n, p, d, r = MEMORY
    tables = torch.randperm(n - 1, generator=gen, device="cuda")[:r, None] + 1
    shapes.append((label, tables, [
        [torch.randn((n, p, d), generator=gen, device="cuda").to(bf)] * 2
        for _ in range(8)]))
    default_plan = kpg.gather_plan
    for spec, (_, fields) in zip(plans, specs):
        kpg.gather_plan = (lambda *a, f=fields, **k: dataclasses.replace(
            default_plan(*a, **k), **f))
        res = {}
        for label, tables, layers in shapes:
            a, b = layers[0]
            got = kpg.paged_gather_kv_cuda(a, b, tables)
            want = [ref.paged_gather_ref(t, tables) for t in (a, b)]
            if not (all(map(torch.equal, got, want)) and torch.equal(
                    kpg.paged_gather_cuda(a, tables), want[0])):
                raise AssertionError(f"plan {spec!r}: {label} output "
                                     f"differs from the plain version")
            plan = kpg.gather_plan(tuple(t.shape[1:] for t in (a, b)),
                                   tables.numel(), 2)
            it = itertools.cycle(layers)
            res[label] = {
                "plan": dataclasses.asdict(plan),
                "one pool": device_ms(torch, lambda: kpg.paged_gather_cuda(
                    next(it)[0], tables), 100, 5),
                "two pools": device_ms(torch, lambda: kpg.
                                       paged_gather_kv_cuda(
                                           *next(it), tables), 100, 5)}
        kpg.gather_plan = default_plan
        print(json.dumps({"kernel": "copy", "set": spec or "default",
                          "ms": res}), flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--kernel", choices=("dequant", "copy"),
                    default="dequant")
    ap.add_argument("--set", action="append", default=[], dest="plans")
    args = ap.parse_args()
    plans = [""] + args.plans
    specs = [parse(p, args.kernel) for p in plans]
    import torch
    if not torch.cuda.is_available():
        print("sweep_gather: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.kernels import build, ref
    # ``repro_torch.kernels`` re-exports the op ``paged_gather`` over the
    # module
    kpg = importlib.import_module("repro_torch.kernels.paged_gather")
    build.build(["paged_gather"])
    if args.kernel == "copy":
        sweep_copy(torch, kpg, ref, plans, specs)
        return _card()
    default_plan = kpg.dequant_plan
    defaults = {k: getattr(kpg, k) for k in CONSTANTS["dequant"]}
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
    return _card()


def _card() -> int:
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(json.dumps({"card": smi}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
