"""Time the spinner, seeded spinner, circulant and paged gather
kernels of one checkout on the card, at the serving shapes and the
library shape, and print one JSON line.

    python src/repro_torch/launch/time_kernels.py [--src DIR] [--label NAME]
        [--kernels spinner,circulant,gather]

``--src`` names the ``src`` directory whose ``repro_torch`` is imported
and built (default: this checkout's). The script calls only the kernel
wrappers' public signatures, so it can time another checkout of the port
(unpacked with ``git archive`` into a directory that .gitignore lists):
run it on both in turns (A, B, B, A) on one card, one run after the
other, and compare only numbers taken that way. ``--kernels`` picks the
groups timed (default: the three kernel groups).

``--kernels ssd_scan`` times the SSD layer's two scan forms instead, at
mamba2-2.7b's full-width serving step (8 rows; a prefill chunk of 16
tokens and a decode token; bf16 activations, f32 state): the chunked
scan that ``ssm.paged_ssm_step`` runs (``ssm._chunk_scan``) against the
reference's token loop (``ssm._token_scan``), each as host ms a call
(synced) and device ms a call (the kernels' time under
``torch.profiler``: the scan's host time exceeds its device time, so
events around queued calls would time the host). It reads private
functions, so it times only checkouts that have them.

The gathers, the bf16 copy (``paged_gather``) and the int8 one
(``paged_gather_dequant``, int8 -> bf16), are timed at the full-width
decode shape (R = 8, M = 16, P = 16, D = 1024, N = 257) and a prefill
shape (R = 32, M = 64, N = 2049), cycling through 36 layers' pools so
pages come from HBM: one pool a call, and a layer's K and V in one
launch (``paged_gather_kv`` and ``paged_gather_dequant_kv`` where the
checkout has them, else two calls of the single-pool kernel, as an
older attention made them). At the decode shape also the host ms of a
layer's K and V through ``kernels.ops`` as the attention calls it (one
``ops.paged_gather_kv``, else two ``ops.paged_gather``), over 2000
calls: the launches are host-bound, so it times the host.

Times: CUDA events over back-to-back launches queued behind a device
sleep, median of the repeats (``chip_smoke.device_ms``). Inputs come
from a seeded generator; no output is checked here (``chip_smoke.py``
and ``tests/test_torch_cuda.py`` do that).
"""
from __future__ import annotations

import argparse
import importlib
import itertools
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

# serving: (label, rows a group, epilogue); n = 128, m = 256
SPINNER_SERVING = [("decode query", 32, "identity"), ("decode key", 8, "exp"),
                   ("prefill query", 512, "identity"),
                   ("prefill key", 128, "exp")]
SEEDED_SERVING = [("decode query", 4, "identity"), ("decode key", 1, "exp"),
                  ("prefill query", 64, "identity"),
                  ("prefill key", 16, "exp")]
LIBRARY = (1, 8192, 1024, 4096)        # G, B, n, m: one estimate's call
CIRCULANT = (4, 1024, 8192, 4096)      # nb, n, B, m (chip_smoke.CIRC_REAL)
GATHER = [("decode", 257, 8, 16), ("prefill", 2049, 32, 64)]   # N, R, M
GATHER_P, GATHER_D, LAYERS = 16, 1024, 36
SSD_SCAN = [("prefill C=16", 16), ("decode C=1", 1)]     # 8 rows a step
GROUPS = ("spinner", "circulant", "gather", "ssd_scan")
DEFAULT_GROUPS = ("spinner", "circulant", "gather")


def device_ms(torch, fn, launches, repeats):
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(50_000_000)
        start.record()
        for _ in range(launches):
            fn()
        end.record()
        torch.cuda.synchronize()
        out.append(start.elapsed_time(end) / launches)
    return statistics.median(out)


def profiled_ms(torch, fn, calls=10):
    """Device ms of one call of ``fn``: its kernels' and copies' time
    under ``torch.profiler`` over ``calls`` calls."""
    from repro_torch.launch.profile_serve import _device_us
    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    cuda = torch.autograd.DeviceType.CUDA
    return sum(_device_us(e) for e in prof.key_averages()
               if getattr(e, "device_type", None) == cuda) / 1e3 / calls


def host_ms(torch, fn, calls=20):
    """Host ms of one call of ``fn``, synced after the calls."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    torch.cuda.synchronize()
    return 1e3 * (time.perf_counter() - t0) / calls


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", default=str(Path(__file__).resolve().parents[2]))
    ap.add_argument("--label", default="this checkout")
    ap.add_argument("--kernels", default=",".join(DEFAULT_GROUPS))
    args = ap.parse_args()
    groups = set(args.kernels.split(","))
    if not groups <= set(GROUPS):
        ap.error(f"--kernels: pick from {GROUPS}")
    sys.path.insert(0, str(Path(args.src).resolve()))
    import torch
    if not torch.cuda.is_available():
        print("time_kernels: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.kernels import build, circulant as kcirc
    # ``repro_torch.kernels`` re-exports the op ``paged_gather`` over the
    # module
    kpg = importlib.import_module("repro_torch.kernels.paged_gather")
    from repro_torch.kernels import ops as kops, spinner as kspin
    t0 = time.perf_counter()
    build.build([{"gather": "paged_gather"}.get(g, g)
                 for g in sorted(groups - {"ssd_scan"})])
    built = time.perf_counter() - t0

    gen = torch.Generator(device="cuda").manual_seed(0)
    dev = "cuda"
    res = {}

    def spin_inputs(gsz, bsz, n, m, dtype):
        x = torch.randn((gsz, bsz, n), generator=gen, device=dev) * n ** -.25
        g = torch.randn((gsz, -(-m // n), n), generator=gen, device=dev)
        d = (2 * torch.randint(0, 2, (2, gsz, n), generator=gen,
                               device=dev) - 1).float()
        return x.to(dtype), g.to(dtype), d[0].to(dtype), d[1].to(dtype)

    def seeds(gsz):
        return torch.randint(0, 2 ** 32, (gsz,), generator=gen, device=dev,
                             dtype=torch.int64)

    for label, n, r, m in GATHER if "gather" in groups else []:
        tables = torch.randint(1, n, (r, m), generator=gen, device=dev)
        layers = [[(torch.randint(-127, 128, (n, GATHER_P, GATHER_D),
                                  generator=gen, device=dev,
                                  dtype=torch.int8),
                    torch.rand((n, GATHER_P, 1), generator=gen,
                               device=dev) / 127) for _ in range(2)]
                  for _ in range(LAYERS)]
        it = itertools.cycle(layers)

        def single():
            (q, sc), _ = next(it)
            kpg.paged_gather_dequant_cuda(q, sc, tables, torch.bfloat16)

        def pair():
            (kq, ks), (vq, vs) = next(it)
            if hasattr(kpg, "paged_gather_dequant_kv_cuda"):
                kpg.paged_gather_dequant_kv_cuda(kq, ks, vq, vs, tables,
                                                 torch.bfloat16)
            else:
                kpg.paged_gather_dequant_cuda(kq, ks, tables, torch.bfloat16)
                kpg.paged_gather_dequant_cuda(vq, vs, tables, torch.bfloat16)

        res[f"dequant {label} one pool"] = device_ms(torch, single, 100, 5)
        res[f"dequant {label} K and V"] = device_ms(torch, pair, 100, 5)
        del layers
        layers = [[torch.randn((n, GATHER_P, GATHER_D), generator=gen,
                               device=dev).to(torch.bfloat16)
                   for _ in range(2)] for _ in range(LAYERS)]
        it = itertools.cycle(layers)

        def copy_single():
            kpg.paged_gather_cuda(next(it)[0], tables)

        def copy_pair():
            k, v = next(it)
            if hasattr(kpg, "paged_gather_kv_cuda"):
                kpg.paged_gather_kv_cuda(k, v, tables)
            else:
                kpg.paged_gather_cuda(k, tables)
                kpg.paged_gather_cuda(v, tables)

        res[f"bf16 {label} one pool"] = device_ms(torch, copy_single, 100, 5)
        res[f"bf16 {label} K and V"] = device_ms(torch, copy_pair, 100, 5)

        def ops_pair():
            k, v = next(it)
            if hasattr(kops, "paged_gather_kv"):
                kops.paged_gather_kv(k, v, tables)
            else:
                kops.paged_gather(k, tables)
                kops.paged_gather(v, tables)

        if label == "decode":
            res["bf16 decode K and V host"] = host_ms(torch, ops_pair, 2000)
        del layers
        torch.cuda.empty_cache()
    for dtype in (torch.bfloat16, torch.float32):
        dt = str(dtype)[6:]
        if "spinner" in groups:
            for label, bsz, epi in SPINNER_SERVING:
                x, g, d0, d1 = spin_inputs(8, bsz, 128, 256, dtype)
                res[f"spinner {label} {dt}"] = device_ms(
                    torch, lambda: kspin.spinner_project_cuda(
                        "circulant", g, x, 256, d0=d0, d1=d1, epilogue=epi,
                        out_scale=256 ** -.5), 100, 5)
            for label, bsz, epi in SEEDED_SERVING:
                x = spin_inputs(64, bsz, 128, 256, dtype)[0]
                sd = seeds(64)
                res[f"seeded {label} {dt}"] = device_ms(
                    torch, lambda: kspin.spinner_project_seeded_cuda(
                        "circulant", sd, x, 256, epilogue=epi,
                        out_scale=256 ** -.5), 100, 5)
            gsz, bsz, n, m = LIBRARY
            x, g, d0, d1 = spin_inputs(gsz, bsz, n, m, dtype)
            res[f"spinner library {dt}"] = device_ms(
                torch, lambda: kspin.spinner_project_cuda(
                    "circulant", g, x, m, d0=d0, d1=d1), 5, 3)
            sd = seeds(gsz)
            res[f"seeded library {dt}"] = device_ms(
                torch, lambda: kspin.spinner_project_seeded_cuda(
                    "circulant", sd, x, m), 5, 3)
            del x, g
        if "circulant" in groups:
            nb, n, b, m = CIRCULANT
            g = torch.randn((nb, n), generator=gen, device=dev).to(dtype)
            x = torch.randn((b, n), generator=gen, device=dev)
            x = (x / x.norm(dim=-1, keepdim=True)).to(dtype)
            res[f"circulant {dt}"] = device_ms(
                torch, lambda: kcirc.circulant_project_cuda(g, x, m), 10, 3)
            del x, g
        torch.cuda.empty_cache()
    if "ssd_scan" in groups:
        from repro_torch.configs import registry
        from repro_torch.models import ssm
        cfg = registry.get("mamba2-2.7b")
        nh, ns, hd = cfg.ssm_heads, cfg.ssm_state, cfg.ssm_head_dim
        a = -torch.linspace(1.0, 16.0, nh, device=dev)   # -exp(the init's)
        for label, c in SSD_SCAN:
            bf = lambda *shape: (torch.randn(  # noqa: E731
                shape, generator=gen, device=dev) * .5).to(torch.bfloat16)
            xs, bs, cs = bf(8, c, nh, hd), bf(8, c, ns), bf(8, c, ns)
            dt = torch.rand((8, c, nh), generator=gen, device=dev) * .1
            s0 = torch.randn((8, nh, ns, hd), generator=gen, device=dev)
            for form, fn in (
                    ("chunk", lambda: ssm._chunk_scan(xs, bs, cs, dt, a, s0,
                                                      c)),
                    ("token", lambda: ssm._token_scan(xs, bs, cs, dt, a,
                                                      s0))):
                res[f"ssd_scan {label} {form} host"] = host_ms(torch, fn)
                res[f"ssd_scan {label} {form} device"] = profiled_ms(torch,
                                                                     fn)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(json.dumps({"label": args.label, "card": smi,
                      "build_s": round(built, 1), "ms": res}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
