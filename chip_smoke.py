"""Smoke run of the PyTorch port on one NVIDIA H100: builds the CUDA
kernels, holds each against its plain PyTorch version, then serves
full-width qwen3-4b with SRF attention through the port's engine.

    python3 chip_smoke.py

Phases (any failure raises, and the script exits non-zero without its
result line):

1. Build: compile ``src/repro_torch/kernels/csrc/*.cu`` (one nvcc per
   source, started together) and print the build time.
2. Kernels against their plain versions on the card, at the serving
   shapes (circulant n=128, m=256, G=8 kv heads; decode query B=32,
   decode key B=8, prefill query B=512, prefill key B=128; bf16 and
   f32), a sweep over every kernel kind x epilogue x grouped/ungrouped
   with ragged B and m, and srf_decode at (B=8, H=32, m=256, dv=128)
   and two ragged shapes.
   Tolerance: max|kernel - plain| <= 1e-4 * max|plain| in f32,
   2e-2 * max|plain| in bf16. Times: CUDA events over back-to-back
   launches queued behind a device sleep, median of 5 repeats.
3. Serve: full-width qwen3-4b (36 layers, d_model 2560, bf16) with SRF
   attention, random weights from a seeded torch.Generator, 8 greedy
   requests (prompt 128, 32 new tokens, 8 slots). Every count is set to
   0 just before and read just after; the run fails unless every request
   finishes with 32 tokens, every sampled logit row is finite, and the
   spinner and srf_decode kernels launched at least 72 per step and 36
   per decode step. A reduced config is also served on the card and on
   the CPU (plain versions); their greedy tokens must be equal.
4. Print the card (nvidia-smi name, power limit), one JSON line with a
   record per kernel, and the result line. ``library_ms`` is null for
   both kernels: no single PyTorch call computes f(A·D1·H·D0·x) with a
   regenerated structured A, or the fused in-place SRF state update and
   readout.
"""
from __future__ import annotations

import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent
PEAK_BYTES_PER_S = 3.35e12        # H100 SXM HBM3 (NVIDIA data sheet)
PEAK_F32_FLOP_PER_S = 67e12       # H100 SXM f32, CUDA cores (data sheet)
TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}


def log(msg: str) -> None:
    print(msg, flush=True)


def device_ms(fn, launches: int = 100, repeats: int = 5) -> float:
    """Median device time of one call of ``fn``: ``launches`` calls queued
    behind a device sleep (so host overhead does not leak into the
    window), timed with CUDA events."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(50_000_000)           # ~25 ms: host queues ahead
        start.record()
        for _ in range(launches):
            fn()
        end.record()
        torch.cuda.synchronize()
        out.append(start.elapsed_time(end) / launches)
    return statistics.median(out)


def max_err(k: torch.Tensor, p: torch.Tensor):
    k, p = k.float(), p.float()
    return (k - p).abs().max().item(), p.abs().max().item()


def check(name: str, k: torch.Tensor, p: torch.Tensor, dtype) -> float:
    if k.shape != p.shape:
        raise AssertionError(f"{name}: shape {tuple(k.shape)} != "
                             f"{tuple(p.shape)}")
    if not torch.isfinite(k).all():
        raise AssertionError(f"{name}: non-finite kernel output")
    err, scale = max_err(k, p)
    limit = TOL[dtype] * scale
    log(f"  {name}: max|k-p| = {err:.3e}  limit = {limit:.3e}")
    if not err <= limit:
        raise AssertionError(f"{name}: max|k-p| {err:.3e} > {limit:.3e}")
    return err


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------

def spinner_inputs(kind, gsz, bsz, n, m, dtype, gen, use_hd=True):
    from repro_torch.kernels import spinner as kspin
    dev = "cuda"
    x = torch.randn((gsz, bsz, n), generator=gen, device=dev) * n ** -0.25
    g = torch.randn(kspin._gen_shape(kind, gsz, n, m), generator=gen,
                    device=dev)
    sign = lambda: (2 * torch.randint(0, 2, (gsz, n), generator=gen,  # noqa
                                      device=dev) - 1).float()
    params = {"g": g.to(dtype)}
    if use_hd:
        params["d0"], params["d1"] = sign().to(dtype), sign().to(dtype)
    return x.to(dtype), params


def bound(byts: float, ops: float):
    """(ms, "bytes" | "operations"): the larger of bytes over the HBM rate
    and f32 operations over the f32 peak (both kernels compute in f32 on
    the CUDA cores)."""
    t_b, t_o = byts / PEAK_BYTES_PER_S, ops / PEAK_F32_FLOP_PER_S
    return 1e3 * max(t_b, t_o), ("bytes" if t_b >= t_o else "operations")


def spinner_bound(kind, gsz, bsz, n, m, itemsize, gen_elems, width):
    """x read once, generator and diagonals read once, output written
    once. Operations: what the function needs, not what the kernel does
    (it regenerates A and takes B*m*n multiply-adds): per row, the fast
    structured matvec's count (``structured.flops_fast``, an FFT product)
    plus the HD butterfly's n*log2(n) adds."""
    from repro_torch.core import structured
    byts = itemsize * gsz * (bsz * n + gen_elems + 2 * n + bsz * width)
    ops = gsz * bsz * (structured.flops_fast(kind, m, n)
                       + n * math.log2(n))
    return bound(byts, ops)


def phase_spinner(gen):
    from repro_torch.kernels import ops, ref, spinner as kspin
    n, m, gsz = 128, 256, 8
    shapes = [("decode query", 32, "identity"), ("decode key", 8, "exp"),
              ("prefill query", 8 * 16 * 4, "identity"),
              ("prefill key", 8 * 16, "exp")]
    records = {}
    for dtype in (torch.bfloat16, torch.float32):
        for label, bsz, epi in shapes:
            x, p = spinner_inputs("circulant", gsz, bsz, n, m, dtype, gen)
            args = ("circulant", p["g"], x, m)
            kw = dict(d0=p["d0"], d1=p["d1"], epilogue=epi,
                      out_scale=m ** -0.5)
            k = kspin.spinner_project_cuda(*args, **kw)
            pl = ref.spinner_project_ref(*args, **kw)
            name = f"spinner {label} {str(dtype)[6:]} (G={gsz}, B={bsz})"
            err = check(name, k, pl, dtype)
            k_ms = device_ms(lambda: kspin.spinner_project_cuda(*args, **kw))
            p_ms = device_ms(lambda: ref.spinner_project_ref(*args, **kw),
                             launches=10, repeats=3)
            b_ms, b_by = spinner_bound("circulant", gsz, bsz, n, m,
                                       x.element_size(),
                                       p["g"][0].numel(), m)
            log(f"    kernel {k_ms:.4f} ms  plain {p_ms:.4f} ms  "
                f"bound {b_ms:.5f} ms ({b_by})")
            records[(label, dtype)] = dict(err=err, ms=k_ms, plain_ms=p_ms,
                                           bound_ms=b_ms, bound_by=b_by)

    # every kernel kind x epilogue x grouped/ungrouped, ragged B and m
    n, m, bsz = 64, 200, 13
    for kind in kspin.KERNEL_KINDS:
        for epi in kspin.EPILOGUES:
            for grouped in (True, False):
                gs = 3 if grouped else 1
                x, p = spinner_inputs(kind, gs, bsz, n, m, torch.float32,
                                      gen)
                if not grouped:
                    x, p = x[0], {k: v[0] for k, v in p.items()}
                before = kspin.spinner_project_cuda.launches
                k = ops.spinner_project(kind, p, x, m, epilogue=epi,
                                        y_scale=0.7, out_scale=m ** -0.5,
                                        grouped=grouped)
                if kspin.spinner_project_cuda.launches != before + 1:
                    raise AssertionError("sweep call did not launch")
                lift = (lambda t: t) if grouped else (lambda t: t[None])

                def plain(e):
                    return ref.spinner_project_ref(
                        kind, lift(p["g"]), lift(x), m, d0=lift(p["d0"]),
                        d1=lift(p["d1"]), epilogue=e, y_scale=0.7,
                        out_scale=m ** -0.5).reshape(k.shape)
                pl = plain(epi)
                if epi in ("heaviside", "sign"):
                    # a step function of y: compare where |y| is not
                    # within f32 summation-order noise of the step
                    y = plain("identity")
                    far = y.abs() > 1e-4 * y.abs().max()
                    k, pl = k[far], pl[far]
                check(f"sweep {kind} {epi} grouped={grouped}", k, pl,
                      torch.float32)
    return records


def phase_srf_decode(gen):
    from repro_torch.kernels import ref, srf_decode as kdec
    b, h, m, dv = 8, 32, 256, 128
    dev = "cuda"
    phi = lambda: torch.rand((b, h, m), generator=gen, device=dev) / 16  # noqa
    s = torch.randn((b, h, m, dv), generator=gen, device=dev) * 4
    z = phi() * 128
    pq, pk = phi(), phi()
    v = torch.randn((b, h, dv), generator=gen, device=dev)
    ps, pz, po = ref.srf_decode_ref(s, z, pq, pk, v)
    ks, kz, ko = kdec.srf_decode_cuda(s.clone(), z.clone(), pq, pk, v)
    errs = [check("srf_decode S'", ks, ps, torch.float32),
            check("srf_decode z'", kz, pz, torch.float32),
            check("srf_decode out (B=8, H=32, m=256, dv=128)", ko, po,
                  torch.float32)]
    for shape in ((2, 3, 37, 13), (1, 2, 300, 260)):   # ragged, unaligned dv
        rs = torch.randn(shape, generator=gen, device=dev)
        rz, rq, rk = (torch.rand(shape[:3], generator=gen, device=dev)
                      for _ in range(3))
        rv = torch.randn(shape[:2] + shape[3:], generator=gen, device=dev)
        want = ref.srf_decode_ref(rs, rz, rq, rk, rv)
        got = kdec.srf_decode_cuda(rs.clone(), rz.clone(), rq, rk, rv)
        for part, k, p in zip(("S'", "z'", "out"), got, want):
            check(f"srf_decode {part} {shape}", k, p, torch.float32)
    s2, z2 = s.clone(), z.clone()
    k_ms = device_ms(lambda: kdec.srf_decode_cuda(s2, z2, pq, pk, v))
    p_ms = device_ms(lambda: ref.srf_decode_ref(s, z, pq, pk, v),
                     launches=20, repeats=3)
    byts = 4 * (2 * b * h * m * dv + 2 * b * h * m + 2 * b * h * m
                + 2 * b * h * dv)
    b_ms, b_by = bound(byts, 4.0 * b * h * m * dv + 4.0 * b * h * m)
    log(f"    kernel {k_ms:.4f} ms  plain {p_ms:.4f} ms  "
        f"bound {b_ms:.5f} ms ({b_by})")
    return dict(err=max(errs), ms=k_ms, plain_ms=p_ms, bound_ms=b_ms,
                bound_by=b_by)


# ---------------------------------------------------------------------------
# phase 3: serve
# ---------------------------------------------------------------------------

def serve_args(**kw):
    from repro_torch.launch import serve
    argv = ["--arch", "qwen3-4b", "--attn", "srf"]
    for k, v in kw.items():
        argv += [f"--{k.replace('_', '-')}"] + ([] if v is True else [str(v)])
    return serve.parser().parse_args(argv)


def phase_reduced_agreement():
    """The reduced config served on the card and on the CPU (plain
    versions) must give the same greedy tokens."""
    from repro_torch.launch import serve
    out = {}
    for device in ("cpu", "cuda"):
        args = serve_args(reduced=True, requests=8, prompt_len=24,
                          max_new=6, slots=4, max_len=64, seed=3,
                          device=device)
        cfg, params = serve.build(serve_args(reduced=True, seed=3,
                                             device="cpu"))
        params = _to(params, device)
        res = serve.serve(args, cfg, params)
        out[device] = {r.uid: r.out_tokens for r in res["done"]}
    if out["cpu"] != out["cuda"] or len(out["cuda"]) != 8:
        raise AssertionError(f"reduced greedy tokens differ between card "
                             f"and CPU: {out}")
    log(f"  reduced qwen3-4b srf: card tokens == CPU tokens "
        f"({sum(len(t) for t in out['cuda'].values())} tokens)")


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_to(v, device) for v in tree)
    return tree.to(device)


def phase_serve():
    from repro_torch.kernels import ops
    from repro_torch.launch import serve
    args = serve_args(requests=8, prompt_len=128, max_new=32, slots=8,
                      max_len=256, seed=0, device="cuda")
    t0 = time.perf_counter()
    cfg, params = serve.build(args)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _leaves(params))
    log(f"  full-width {cfg.name}: {cfg.n_layers} layers, d_model "
        f"{cfg.d_model}, {cfg.dtype}, {n_params / 1e9:.3f} B params, "
        f"SRF {cfg.srf.kind} m={cfg.srf.n_features}; init "
        f"{time.perf_counter() - t0:.1f} s")
    serve.warm(args, cfg, params)
    torch.cuda.reset_peak_memory_stats()
    ops.reset_counts()
    res = serve.serve(args, cfg, params)
    counts = ops.launch_counts()
    eng = res["engine"]
    steps = eng.stats["prefill_steps"] + eng.stats["decode_steps"]
    dsteps = eng.stats["decode_steps"]
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    log(f"  served {len(res['done'])} requests, {res['tokens']} tokens in "
        f"{res['wall_s']:.3f} s: {res['tok_s']:.1f} tok/s, TTFT p50 "
        f"{res['ttft_s']['p50']:.4f} s, {eng.stats['prefill_steps']} "
        f"prefill + {dsteps} decode steps, peak memory {peak:.2f} GiB")
    log(f"  launches: {counts}")
    bad = [r.uid for r in res["done"] if len(r.out_tokens) != args.max_new]
    if len(res["done"]) != args.requests or bad:
        raise AssertionError(f"requests not finished with {args.max_new} "
                             f"tokens: {bad}")
    if eng.nonfinite_rows:
        raise AssertionError(f"{eng.nonfinite_rows} logit rows not finite")
    if counts["spinner"] < 2 * cfg.n_layers * steps:
        raise AssertionError(f"spinner launched {counts['spinner']} times, "
                             f"< {2 * cfg.n_layers} per step x {steps}")
    if counts["srf_decode"] < cfg.n_layers * dsteps:
        raise AssertionError(f"srf_decode launched {counts['srf_decode']} "
                             f"times, < {cfg.n_layers} per decode step x "
                             f"{dsteps}")
    if counts["spinner_plain_on_cuda"]:
        raise AssertionError("spinner calls on the card took the plain "
                             "version")
    return counts


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (tuple, list)):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import build

    log(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}, {torch.cuda.get_device_name(0)}")
    log("phase 1: build")
    t0 = time.perf_counter()
    libs = build.build(["spinner", "srf_decode"])
    log(f"  built {sorted(libs)} in {time.perf_counter() - t0:.1f} s")

    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    log("phase 2: kernels against their plain versions")
    spin = phase_spinner(gen)
    dec = phase_srf_decode(gen)

    log("phase 3: serve")
    phase_reduced_agreement()
    counts = phase_serve()

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    log(smi.stdout.strip().splitlines()[0])
    q = spin[("decode query", torch.bfloat16)]
    kernels = [
        {"name": "spinner", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/spinner.cu",
         "replaces": "src/repro/kernels/spinner.py:111",
         "launches": counts["spinner"], "max_abs_err": q["err"],
         "ms": q["ms"], "plain_ms": q["plain_ms"],
         "bound_ms": q["bound_ms"], "bound_by": q["bound_by"],
         "library_ms": None,
         "shape": "decode query: G=8, B=32, n=128, m=256, bf16, identity"},
        {"name": "srf_decode", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/srf_decode.cu",
         "replaces": "src/repro/kernels/srf_decode.py:26",
         "launches": counts["srf_decode"], "max_abs_err": dec["err"],
         "ms": dec["ms"], "plain_ms": dec["plain_ms"],
         "bound_ms": dec["bound_ms"], "bound_by": dec["bound_by"],
         "library_ms": None,
         "shape": "B=8, H=32, m=256, dv=128, f32"}]
    log(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
