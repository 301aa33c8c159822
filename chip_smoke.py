"""Smoke run of the PyTorch port on one NVIDIA H100: builds the CUDA
kernels, holds each against its plain PyTorch version, runs the paper's
kernel estimates through the port's library, then serves full-width
qwen3-4b through the port's engine with full-KV pages (bf16, int8,
prefix cache), with SRF attention, and with seeded SRF attention
(per-request embed seeds, greedy and sampled requests in one batch).

    python3 chip_smoke.py

Phases (any failure raises, and the script exits non-zero without its
result line):

1. Build: compile ``src/repro_torch/kernels/csrc/*.cu`` (one nvcc per
   source, started together) and print the build time.
2. Kernels against their plain versions on the card.
   * spinner at the serving shapes (circulant n=128, m=256, G=8 kv heads;
     decode query B=32, decode key B=8, prefill query B=512, prefill key
     B=128; bf16 and f32) and a sweep over every kernel kind x epilogue x
     grouped/ungrouped with ragged B and m; srf_decode at (B=8, H=32,
     m=256, dv=128) and two ragged shapes. Tolerance: max|kernel - plain|
     <= 1e-4 * max|plain| in f32, 2e-2 * max|plain| in bf16.
   * paged_gather (bf16, f32, int8 pools) and paged_gather_dequant (int8
     -> bf16, f32) at the full-width decode shape (R=8, M=16, P=16,
     D=1024), a prefill-sized shape (R=32, M=64) and ragged shapes (row
     bytes not a multiple of 16, ids out of range), int32 and int64
     tables: bit-equal (torch.equal).
   * the seeded spinner at the seeded serving shapes (circulant n=128,
     m=256, G = 8 kv heads x 8 requests = 64 groups; decode query B=4,
     decode key B=1, prefill query B=64, prefill key B=16; bf16 and f32)
     and a sweep over every kernel kind x epilogue x grouped/ungrouped
     with ragged B and m: held to its plain version (the tolerance
     above) and to the materialized spinner kernel run on
     ``seedgen.grouped_params`` computed on the card (bit-equal, or
     within the tolerance: bf16 generators are rounded for the
     materialized kernel); distinct seeds must give distinct outputs.
     The plain stateless sampler is timed at the full-width decode
     shape (8 rows x 151936 logits, mixed greedy and sampled rows):
     device time under ``torch.profiler``, and time a call by events.
   * fwht at the reference test shapes, (8192, 1024) and (4096, 16384),
     f32 and bf16, normalized and not; circulant_project at the five
     reference test shapes and g (4, 1024), x (8192, 1024), m = 4096,
     every epilogue, f32 and bf16: within ``tests/test_kernels.py``'s
     ``_tol`` of the plain version (exp in log space; heaviside where
     |y| > 1e-3, the flips below counted). Then the public ops alone at
     the real shapes, their launches counted (0 before, read after).
     Times at (8192, 1024) f32 and at the real circulant shape beside
     ``x @ H_n`` and ``x @ A.T``.
   Times: CUDA events over back-to-back launches queued behind a device
   sleep, median of 5 repeats (3 for the circulant); the gathers cycle
   through 36 layer pools, as a decode step does, so pages come from HBM.
3. The kernel-estimation library: ``estimators.estimate`` of 8192 pairs
   of unit vectors (n = 1024, m = 4096 and 256; ``spinner.single`` and
   ``spinner.hd_chain`` depth 3, circulant; f identity, heaviside,
   sign, relu, trig, softmax), the card route against the plain route
   on the same params, the error falling with m, the spinner launched
   and never its plain version; ``mc_error`` for the sweep of
   ``examples/kernel_approx.py``.
4. Serve full-width qwen3-4b (36 layers, d_model 2560, 32 q / 8 kv heads
   of 128, bf16), random weights from a seeded torch.Generator, 8 greedy
   requests (prompt 128, 32 new tokens, 8 slots, max_len 256): with full
   KV on bf16 pages, on int8 pages, and with the prefix cache (prompts
   sharing their first 96 tokens; a cold wave, then the same prompts
   warm, in one engine); then with SRF attention. Every count is set to
   0 just before each run and read just after; a run fails unless every
   request finishes with 32 tokens, every sampled logit row is finite,
   and its kernels launched as the path needs (full KV: paged_gather, or
   paged_gather_dequant on int8 pages, exactly 72 per step and the other
   gathers never; SRF: the spinner at least 72 per step and srf_decode
   36 per decode step). The prefix run must serve prompt tokens from the
   cache and leak no page. Then seeded SRF (``SRFAttnConfig(seeded=True)``,
   one seed per layer and kv head): embed_seed 0 for uids 0-3 and a
   distinct non-zero seed for uids 4-7, odd uids sampled (temperature
   0.8, top_k 40, top_p 0.95), even uids greedy; the seeded spinner at
   least 72 per step, srf_decode exactly 36 per decode step, the
   materialized spinner and the seeded plain route never. Both SRF
   runs publish exactly one live quality sample (``srf_quality`` gauge,
   stats finite and under ``DRIFT_TOL``, no ``quality_drift``). Reduced
   configs (SRF; full KV with bf16 and with int8 pages; seeded SRF with
   mixed embed seeds and mixed greedy / sampled requests) are also
   served on the card and on the CPU (plain versions); their tokens
   must be equal.
5. Print the card (nvidia-smi name, power limit), one JSON line with a
   record per kernel, and the result line. ``library_ms`` is
   ``pool[tables]`` for paged_gather, ``x @ H_n`` for fwht, ``x @ A.T``
   for circulant_project, and null for the others: no single
   PyTorch call computes f(A·D1·H·D0·x) with a regenerated structured A
   (nor with A, D0 and D1 regenerated from a seed), the fused in-place
   SRF state update and readout, or a gather fused with the int8
   dequant.
"""
from __future__ import annotations

import dataclasses
import gc
import itertools
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


def exact(name: str, k: torch.Tensor, p: torch.Tensor) -> None:
    """Bit equality (same shape, dtype and bits)."""
    if k.shape != p.shape or k.dtype != p.dtype or not torch.equal(k, p):
        raise AssertionError(f"{name}: kernel != plain version")
    log(f"  {name}: bit-equal")


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


# operations counted per generated value in the seeded spinner's bound:
# one threefry2x32 call is 20 rounds of (add, rotate = 2 shifts + or,
# xor) plus 5 key injections of 3 adds: 115 integer operations; the
# Box-Muller step adds 2 mantissa fills (3 each), 2 subtractions, a
# multiply and log, sqrt and cos, counted as 10 each: 40. A sign is one
# cipher call and a compare.
OPS_PER_NORMAL = 115 + 40
OPS_PER_SIGN = 115 + 1


def seeded_bound(kind, gsz, bsz, n, m, itemsize, width):
    """x read once, the output written once, and each group's 8-byte seed
    (the port's int64 word; the reference reads a 4-byte uint32).
    Operations: the spinner's rule (``spinner_bound``) plus drawing each
    group's generator (its canonical size: nb*n for circulant, n+m-1 for
    toeplitz/hankel, m*n dense) and 2n signs once."""
    from repro_torch.core import structured
    gen_elems = {"circulant": -(-m // n) * n, "skew_circulant": -(-m // n) * n,
                 "toeplitz": n + m - 1, "hankel": n + m - 1,
                 "unstructured": m * n}[kind]
    byts = itemsize * gsz * bsz * (n + width) + 8 * gsz
    ops = gsz * bsz * (structured.flops_fast(kind, m, n) + n * math.log2(n))
    ops += gsz * (gen_elems * OPS_PER_NORMAL + 2 * n * OPS_PER_SIGN)
    return bound(byts, ops)


def _materialized_twin(kind, seeds, x, m, epi, y_scale, out_scale):
    """The materialized spinner kernel on ``seedgen.grouped_params(seeds)``
    computed by PyTorch on the card (cast to x's dtype)."""
    from repro_torch.kernels import seedgen, spinner as kspin
    p = seedgen.grouped_params(kind, x.shape[-1], m, seeds)
    return kspin.spinner_project_cuda(
        kind, p["g"].to(x.dtype).contiguous(), x, m,
        d0=p["d0"].to(x.dtype), d1=p["d1"].to(x.dtype), epilogue=epi,
        y_scale=y_scale, out_scale=out_scale)


def _against_twin(name, k, twin, dtype):
    """Bit-equal to the materialized twin, or within the tolerance."""
    if k.shape == twin.shape and torch.equal(k, twin):
        log(f"    {name}: seeded == materialized kernel, bit-equal")
        return True
    check(f"{name} vs materialized kernel", k, twin, dtype)
    return False


def phase_seeded_spinner(gen):
    """The seeded spinner kernel at the seeded serving shapes and over
    every kind x epilogue x grouped/ungrouped."""
    from repro_torch.kernels import ops, ref, seedgen, spinner as kspin
    dev = "cuda"
    n, m, gsz = 128, 256, 64
    shapes = [("decode query", 4, "identity"), ("decode key", 1, "exp"),
              ("prefill query", 64, "identity"), ("prefill key", 16, "exp")]
    records, equal = {}, 0
    for dtype in (torch.bfloat16, torch.float32):
        for label, bsz, epi in shapes:
            x = (torch.randn((gsz, bsz, n), generator=gen, device=dev)
                 * n ** -0.25).to(dtype)
            seeds = torch.randint(0, 2 ** 32, (gsz,), generator=gen,
                                  device=dev, dtype=torch.int64)
            kw = dict(use_hd=True, epilogue=epi, out_scale=m ** -0.5)
            k = kspin.spinner_project_seeded_cuda("circulant", seeds, x, m,
                                                  **kw)
            pl = ref.spinner_project_seeded_ref("circulant", seeds, x, m,
                                                **kw)
            name = (f"seeded spinner {label} {str(dtype)[6:]} "
                    f"(G={gsz}, B={bsz})")
            err = check(name, k, pl, dtype)
            twin = _materialized_twin("circulant", seeds, x, m, epi, 1.0,
                                      m ** -0.5)
            equal += _against_twin(name, k, twin, dtype)
            k_ms = device_ms(lambda: kspin.spinner_project_seeded_cuda(
                "circulant", seeds, x, m, **kw))
            p_ms = device_ms(lambda: ref.spinner_project_seeded_ref(
                "circulant", seeds, x, m, **kw), launches=10, repeats=3)
            gp = {k_: v.to(dtype) for k_, v in seedgen.grouped_params(
                "circulant", n, m, seeds).items()}
            mat_ms = device_ms(lambda: kspin.spinner_project_cuda(
                "circulant", gp["g"], x, m, d0=gp["d0"], d1=gp["d1"],
                epilogue=epi, out_scale=m ** -0.5))
            b_ms, b_by = seeded_bound("circulant", gsz, bsz, n, m,
                                      x.element_size(), m)
            log(f"    kernel {k_ms:.4f} ms  plain {p_ms:.4f} ms  "
                f"materialized kernel {mat_ms:.4f} ms  bound {b_ms:.5f} ms "
                f"({b_by})")
            records[(label, dtype)] = dict(err=err, ms=k_ms, plain_ms=p_ms,
                                           materialized_ms=mat_ms,
                                           bound_ms=b_ms, bound_by=b_by)

    # every kernel kind x epilogue x grouped/ungrouped, ragged B and m
    n, m, bsz, cases = 64, 200, 13, 0
    for kind in kspin.KERNEL_KINDS:
        for epi in kspin.EPILOGUES:
            for grouped in (True, False):
                gs = 3 if grouped else 1
                x = torch.randn((gs, bsz, n), generator=gen, device=dev) \
                    * n ** -0.25
                seeds = torch.randint(0, 2 ** 32, (gs,), generator=gen,
                                      device=dev, dtype=torch.int64)
                xa, sa = (x, seeds) if grouped else (x[0], seeds[0])
                before = kspin.spinner_project_seeded_cuda.launches
                k = ops.spinner_project_seeded(
                    kind, sa, xa, m, epilogue=epi, y_scale=0.7,
                    out_scale=m ** -0.5, grouped=grouped)
                if kspin.spinner_project_seeded_cuda.launches != before + 1:
                    raise AssertionError("seeded sweep call did not launch")
                k = k.reshape((gs, bsz, -1))

                def plain(e, s=seeds):
                    return ref.spinner_project_seeded_ref(
                        kind, s, x, m, epilogue=e, y_scale=0.7,
                        out_scale=m ** -0.5)
                pl, twin = plain(epi), _materialized_twin(
                    kind, seeds, x, m, epi, 0.7, m ** -0.5)
                name = f"seeded sweep {kind} {epi} grouped={grouped}"
                equal += _against_twin(name, k, twin, torch.float32)
                kk = k
                if epi in ("heaviside", "sign"):
                    # a step function of y: compare where |y| is not
                    # within f32 summation-order noise of the step
                    y = plain("identity")
                    far = y.abs() > 1e-4 * y.abs().max()
                    kk, pl = k[far], pl[far]
                check(name, kk, pl, torch.float32)
                other = ops.spinner_project_seeded(
                    kind, (sa + 1) % 2 ** 32, xa, m, epilogue=epi,
                    y_scale=0.7, out_scale=m ** -0.5, grouped=grouped)
                if torch.equal(other.reshape(k.shape), k):
                    raise AssertionError(f"{name}: distinct seeds gave the "
                                         f"same output")
                cases += 1
    log(f"  seeded spinner: {cases} sweep cases and 8 serving shapes; "
        f"{equal} of {cases + 8} bit-equal to the materialized kernel; "
        f"distinct seeds gave distinct outputs in every sweep case")
    return records


def profiled_device_ms(fn, calls: int = 10) -> float:
    """Device time of one call of ``fn``: the sum of its kernels' and
    copies' device time under ``torch.profiler``, over ``calls`` calls.
    Unlike ``device_ms`` it leaves out the gaps in which the device waits
    for the host (a copy from pageable host memory synchronizes)."""
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
    us = sum(_device_us(e) for e in prof.key_averages()
             if getattr(e, "device_type", None) == cuda)
    return us / 1e3 / calls


def phase_sampler(gen):
    """The plain stateless sampler at the full-width decode shape, as the
    engine calls it (host arrays for the per-row settings): 8 rows of
    151936 logits, 4 greedy and 4 sampled (temperature 0.8, top_k 40,
    top_p 0.95). Device time from the profiler; time per call from CUDA
    events, which also holds the device's waits on the host (each
    host-to-device copy of the row settings synchronizes)."""
    import numpy as np
    from repro_torch.kernels import seedgen
    from repro_torch.serving import sampler
    b, v = 8, 151936
    logits = torch.randn((b, v), generator=gen, device="cuda") * 4
    temps = np.array([0.0, 0.8] * 4, np.float32)
    ks, ps = np.full(b, 40, np.int64), np.full(b, 0.95, np.float32)
    uids, pos = np.arange(b, dtype=np.int64), np.full(b, 17, np.int64)
    key = seedgen.threefry_seed(0, "cuda")

    def call(t):
        return lambda: sampler.sample_stateless(key, uids, pos, logits, t,
                                                ks, ps)
    dev = profiled_device_ms(call(temps))
    per_call = device_ms(call(temps), launches=20, repeats=3)
    greedy = profiled_device_ms(call(np.zeros(b, np.float32)))
    log(f"  plain stateless sampler (B={b}, V={v}): device {dev:.4f} ms "
        f"a call with sampled rows ({greedy:.4f} ms all greedy: argmax "
        f"only); {per_call:.4f} ms a call by CUDA events")
    return dev


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


def _layer_pools(n_layers, n, p, d, dtype, gen):
    """``n_layers`` distinct pools, as the model has one per layer: cycling
    through them reads cold pages (36 x 8.4 MB outgrows the 50 MB L2)."""
    dev = "cuda"
    if dtype == torch.int8:
        return [torch.randint(-127, 128, (n, p, d), generator=gen,
                              device=dev, dtype=torch.int8)
                for _ in range(n_layers)]
    return [torch.randn((n, p, d), generator=gen, device=dev).to(dtype)
            for _ in range(n_layers)]


def _cycle(fn, pools):
    it = itertools.cycle(pools)
    return lambda: fn(next(it))


def phase_paged_gather(gen):
    """Both gathers, bit-equal (torch.equal) to their plain versions at
    the full-width decode shape (R=8 rows, M=16 pages of P=16 tokens,
    D = 8 kv heads x 128; N=257 pages, the engine's default pool), a
    prefill-sized shape (R=32, M=64) and ragged shapes (row bytes not a
    multiple of 16, ids out of range on both sides)."""
    from repro_torch.kernels import paged_gather as kpg, ref
    dev = "cuda"
    shapes = [("decode", 257, 16, 1024, 8, 16),
              ("prefill", 2049, 16, 1024, 32, 64),
              ("ragged a", 7, 3, 13, 3, 5), ("ragged b", 11, 5, 7, 4, 3),
              ("ragged c", 9, 2, 1, 5, 2)]
    records = {}
    for label, n, p, d, r, m in shapes:
        ragged = label.startswith("ragged")
        lo, hi = (-3, n + 3) if ragged else (1, n)
        tables = torch.randint(lo, hi, (r, m), generator=gen, device=dev,
                               dtype=torch.int64)
        for tdt in (torch.int64, torch.int32):
            t = tables.to(tdt)
            for dtype in (torch.bfloat16, torch.float32, torch.int8):
                pool = _layer_pools(1, n, p, d, dtype, gen)[0]
                k = kpg.paged_gather_cuda(pool, t)
                pl = ref.paged_gather_ref(pool, t)
                exact(f"paged_gather {label} {str(dtype)[6:]} "
                      f"(N={n}, P={p}, D={d}, R={r}, M={m}, {str(tdt)[6:]})",
                      k, pl)
            q = _layer_pools(1, n, p, d, torch.int8, gen)[0]
            sc = torch.rand((n, p, 1), generator=gen, device=dev) / 127
            for odt in (torch.bfloat16, torch.float32):
                k = kpg.paged_gather_dequant_cuda(q, sc, t, odt)
                pl = ref.paged_gather_dequant_ref(q, sc, t, odt)
                exact(f"paged_gather_dequant {label} int8->{str(odt)[6:]} "
                      f"(N={n}, P={p}, D={d}, R={r}, M={m}, {str(tdt)[6:]})",
                      k, pl)
        if ragged:
            continue
        # times: cycling through 36 layer pools, as one decode step does
        nl = 36
        pools = _layer_pools(nl, n, p, d, torch.bfloat16, gen)
        qpools = _layer_pools(nl, n, p, d, torch.int8, gen)
        scs = [torch.rand((n, p, 1), generator=gen, device=dev) / 127
               for _ in range(nl)]
        spools = list(zip(qpools, scs))
        rows = r * m * p
        g_ms = device_ms(_cycle(lambda a: kpg.paged_gather_cuda(a, tables),
                                pools))
        g_plain = device_ms(_cycle(lambda a: ref.paged_gather_ref(a, tables),
                                   pools))
        g_lib = device_ms(_cycle(lambda a: a[tables], pools))
        g_b, g_by = bound(2 * rows * d * 2, 0)
        dq_ms = device_ms(_cycle(lambda a: kpg.paged_gather_dequant_cuda(
            a[0], a[1], tables, torch.bfloat16), spools))
        dq_plain = device_ms(_cycle(lambda a: ref.paged_gather_dequant_ref(
            a[0], a[1], tables, torch.bfloat16), spools))
        dq_b, dq_by = bound(rows * d + 4 * rows + 2 * rows * d,
                            rows * d)
        log(f"    {label} paged_gather bf16: kernel {g_ms:.4f} ms  plain "
            f"{g_plain:.4f} ms  pool[tables] {g_lib:.4f} ms  bound "
            f"{g_b:.5f} ms ({g_by})")
        log(f"    {label} paged_gather_dequant int8->bf16: kernel "
            f"{dq_ms:.4f} ms  plain {dq_plain:.4f} ms  bound {dq_b:.5f} ms "
            f"({dq_by})")
        records[label] = {
            "paged_gather": dict(err=0.0, ms=g_ms, plain_ms=g_plain,
                                 library_ms=g_lib, bound_ms=g_b,
                                 bound_by=g_by),
            "paged_gather_dequant": dict(err=0.0, ms=dq_ms,
                                         plain_ms=dq_plain, library_ms=None,
                                         bound_ms=dq_b, bound_by=dq_by)}
    return records


def allclose(name, k, p, rtol, atol):
    """Elementwise |k - p| <= atol + rtol |p| (``tests/test_kernels.py``'s
    ``_tol`` numbers); returns max|k - p|."""
    if k.shape != p.shape:
        raise AssertionError(f"{name}: shape {tuple(k.shape)} != "
                             f"{tuple(p.shape)}")
    k, p = k.float(), p.float()
    if not torch.isfinite(k).all():
        raise AssertionError(f"{name}: non-finite kernel output")
    diff = (k - p).abs()
    bad = int((diff > atol + rtol * p.abs()).sum())
    err = diff.max().item() if diff.numel() else 0.0
    if bad:
        raise AssertionError(f"{name}: {bad} elements outside rtol={rtol}, "
                             f"atol={atol} (max|k-p| {err:.3e})")
    return err


def _tol(dtype, epilogue="identity"):
    """``tests/test_kernels.py:_tol``."""
    if dtype == torch.bfloat16:
        if epilogue in ("cos_sin", "exp"):
            return dict(rtol=5e-2, atol=1.5e-1)
        return dict(rtol=2e-2, atol=2e-2)
    return dict(rtol=2e-5, atol=2e-5)


FWHT_TEST = [(1, 8), (4, 64), (16, 128), (5, 512), (300, 32)]
FWHT_REAL = [(8192, 1024), (4096, 16384)]


def _fwht_module():
    import importlib          # ``repro_torch.kernels`` re-exports op fwht
    return importlib.import_module("repro_torch.kernels.fwht")


def phase_fwht(gen):
    """ops.fwht at the reference test shapes and at (8192, 1024) and
    (4096, 16384), f32 and bf16, normalized and not, against the plain
    version (``_tol``); then the public op alone at the two real shapes
    (its counted launches); times at (8192, 1024) f32: the kernel, the
    plain version, the bound, and ``x @ H_n`` with the dense normalized
    Hadamard (the one PyTorch call computing the same function)."""
    from repro_torch.core import transforms
    from repro_torch.kernels import ops, ref
    kfwht = _fwht_module()
    dev, errs, equal, cases = "cuda", [], 0, 0
    for b, n in FWHT_TEST + FWHT_REAL:
        for dtype in (torch.float32, torch.bfloat16):
            x = torch.randn((b, n), generator=gen, device=dev).to(dtype)
            for normalized in (True, False):
                k = kfwht.fwht_cuda(x, normalized)
                p = ref.fwht_ref(x, normalized)
                err = allclose(f"fwht ({b}, {n}) {str(dtype)[6:]} "
                               f"normalized={normalized}", k, p,
                               **_tol(dtype))
                equal += torch.equal(k, p)
                cases += 1
                if (b, n) == FWHT_REAL[0] and dtype == torch.float32 \
                        and normalized:
                    errs.append(err)
    log(f"  fwht: {cases} cases within _tol of the plain version, {equal} "
        f"bit-equal")
    xs = {(b, n, dt): torch.randn((b, n), generator=gen, device=dev).to(dt)
          for b, n in FWHT_REAL for dt in (torch.float32, torch.bfloat16)}
    torch.cuda.synchronize()
    ops.reset_counts()
    for x in xs.values():
        ops.fwht(x)
    counts = ops.launch_counts()
    if counts["fwht"] != len(xs) or counts["fwht_plain_on_cuda"]:
        raise AssertionError(f"fwht: the public op at the real shapes "
                             f"launched {counts}")
    b, n = FWHT_REAL[0]
    x = xs[(b, n, torch.float32)]
    h = transforms.hadamard(n, device=dev)
    k_ms = device_ms(lambda: kfwht.fwht_cuda(x))
    p_ms = device_ms(lambda: ref.fwht_ref(x), launches=20, repeats=3)
    lib_ms = device_ms(lambda: x @ h)
    b_ms, b_by = bound(2 * 4 * b * n, b * n * math.log2(n) + b * n)
    big = xs[(*FWHT_REAL[1], torch.float32)]
    big_ms = device_ms(lambda: kfwht.fwht_cuda(big), launches=20)
    big_b, _ = bound(2 * 4 * big.numel(), 0)
    log(f"    ({b}, {n}) f32: kernel {k_ms:.4f} ms  plain {p_ms:.4f} ms  "
        f"x @ H_n {lib_ms:.4f} ms  bound {b_ms:.5f} ms ({b_by}); "
        f"{FWHT_REAL[1]} f32: kernel {big_ms:.4f} ms  bound {big_b:.5f} ms")
    return dict(err=max(errs), ms=k_ms, plain_ms=p_ms, library_ms=lib_ms,
                bound_ms=b_ms, bound_by=b_by, launches=counts["fwht"])


CIRC_TEST = [(1, 16, 4, 16), (2, 32, 8, 48), (4, 64, 16, 256),
             (1, 128, 300, 128), (2, 256, 7, 512)]
CIRC_REAL = (4, 1024, 8192, 4096)      # g (4, 1024), x (8192, 1024), m
STEP_EPS = 1e-3                        # |y| below it: a step may flip


def _circ_inputs(nb, n, b, dtype, gen, unit=False):
    dev = "cuda"
    g = torch.randn((nb, n), generator=gen, device=dev).to(dtype)
    x = torch.randn((b, n), generator=gen, device=dev)
    x = x / x.norm(dim=-1, keepdim=True) if unit else x * 0.3
    x = x.to(dtype)
    return g, x, 0.5 * (x.float() ** 2).sum(-1)


def phase_circulant(gen):
    """ops.circulant_project at the five reference test shapes and the real
    shape (g (4, 1024), unit-norm x (8192, 1024), m = 4096), every
    epilogue, f32 and bf16, against the plain version (``_tol``; exp in
    log space; heaviside where |y| of the plain version exceeds
    STEP_EPS, the sign flips below it counted); then the public op
    alone at the real shape, every epilogue and dtype (its counted
    launches); times at the real shape, identity, f32: the kernel, the
    plain version, the bound, and ``x @ A.T`` on the plain version's
    own materialized A."""
    from repro_torch.core import structured
    from repro_torch.kernels import circulant as kcirc, ops, ref
    flips, near, cases, errs = 0, 0, 0, []
    for nb, n, b, m in CIRC_TEST + [CIRC_REAL]:
        real = (nb, n, b, m) == CIRC_REAL
        for dtype in (torch.float32, torch.bfloat16):
            g, x, sq = _circ_inputs(nb, n, b, dtype, gen, unit=real)
            y = ref.circulant_project_ref(g, x, m).float()
            for epi in kcirc.EPILOGUES:
                k = kcirc.circulant_project_cuda(g, x, m, epi, sq).float()
                p = ref.circulant_project_ref(g, x, m, epi, sq).float()
                name = (f"circulant ({nb}, {n}, {b}, {m}) {epi} "
                        f"{str(dtype)[6:]}")
                if epi == "exp":
                    k, p = k.log(), p.log()
                if epi == "heaviside":
                    close = y.abs() <= STEP_EPS
                    near += int(close.sum())
                    flips += int((k != p)[close].sum())
                    k, p = k[~close], p[~close]
                err = allclose(name, k, p, **_tol(dtype, epi))
                if real and dtype == torch.float32 and epi == "identity":
                    errs.append(err)
                cases += 1
    log(f"  circulant: {cases} cases within _tol of the plain version; "
        f"heaviside: {flips} sign flips among {near} outputs with "
        f"|y| <= {STEP_EPS}")
    nb, n, b, m = CIRC_REAL
    ins = {dt: _circ_inputs(nb, n, b, dt, gen, unit=True)
           for dt in (torch.float32, torch.bfloat16)}
    torch.cuda.synchronize()
    ops.reset_counts()
    for g, x, sq in ins.values():
        for epi in kcirc.EPILOGUES:
            ops.circulant_project(g, x, m, epi, sq)
    counts = ops.launch_counts()
    if counts["circulant_project"] != 2 * len(kcirc.EPILOGUES):
        raise AssertionError(f"circulant: the public op at the real shape "
                             f"launched {counts}")
    g, x, _ = ins[torch.float32]
    a = ref.circulant_matrix(g, m)
    k_ms = device_ms(lambda: kcirc.circulant_project_cuda(g, x, m),
                     launches=10, repeats=3)
    p_ms = device_ms(lambda: ref.circulant_project_ref(g, x, m),
                     launches=10, repeats=3)
    lib_ms = device_ms(lambda: x @ a.T, launches=10, repeats=3)
    b_ms, b_by = bound(4 * (b * n + nb * n + b * m),
                       b * structured.flops_fast("circulant", m, n))
    log(f"    real shape f32 identity: kernel {k_ms:.4f} ms  plain "
        f"{p_ms:.4f} ms  x @ A.T {lib_ms:.4f} ms  bound {b_ms:.5f} ms "
        f"({b_by}); the kernel's {b * m * n / 1e9:.1f} G FMAs at "
        f"{2 * b * m * n / k_ms / 1e9:.1f} TFLOP/s")
    return dict(err=max(errs), ms=k_ms, plain_ms=p_ms, library_ms=lib_ms,
                bound_ms=b_ms, bound_by=b_by,
                launches=counts["circulant_project"])


# ---------------------------------------------------------------------------
# phase 3: the kernel-estimation library
# ---------------------------------------------------------------------------

FNAMES = ("identity", "heaviside", "sign", "relu", "trig", "softmax")
STEP_F = {"heaviside": 1.0, "sign": 2.0}   # the most one flip moves a term


class plain_route:
    """Inside: every spinner call on the card takes the dispatcher's plain
    version (its written rule, ``kernel_takes``, forced false). The
    plain calls made inside are not counted, and no kernel launches."""

    def __enter__(self):
        from repro_torch.kernels import ops
        self.saved = (ops.kernel_takes, ops.spinner_project.plain_calls,
                      ops.launch_counts()["spinner"])
        ops.kernel_takes = lambda *a, **k: False

    def __exit__(self, *exc):
        from repro_torch.kernels import ops
        ops.kernel_takes, ops.spinner_project.plain_calls, launched = \
            self.saved
        if ops.launch_counts()["spinner"] != launched:
            raise AssertionError("the plain route launched the kernel")


def _near_step(pipe, params, v):
    """Per row: how many of the last block's projections lie within
    1e-4 of the largest of them (f32 summation-order noise), where a
    step f may flip between the kernel and the plain version."""
    y = pipe.with_f("identity").apply(params, v)
    return (y.abs() <= 1e-4 * y.abs().max()).sum(-1)


def phase_estimators(gen):
    """The paper's kernel estimates (``core.estimators.estimate``) of
    N = 8192 pairs of unit vectors of width n = 1024 with features of
    width m = 4096, through spinner.single and spinner.hd_chain (depth
    3) circulant pipelines, f in FNAMES: the card route (spinner kernel)
    against the plain route on the same params (1e-4 of the largest
    plain estimate; step f also within the terms that may flip); mean
    |estimate - exact| per f, which must fall from m = 256 to m = 4096.
    Then ``mc_error`` for the sweep of examples/kernel_approx.py (n=128;
    unstructured, circulant, toeplitz, ldr; heaviside and trig; m 16 ...
    1024; 32 trials): the error at m = 1024 below m = 16 everywhere."""
    from repro_torch.core import estimators, spinner
    from repro_torch.kernels import ops
    dev = "cuda"
    N, n = 8192, 1024
    v = torch.randn((2, N, n), generator=gen, device=dev)
    v1, v2 = v / v.norm(dim=-1, keepdim=True)
    closed = {f: estimators.exact(f, v1, v2) for f in FNAMES}
    errs, worst = {}, 0.0
    ops.reset_counts()
    for build in ("single", "hd_chain"):
        for m in (256, 4096):
            kw = dict(m=m, n=n) if build == "single" else \
                dict(n=n, m=m, depth=3)
            pipe = getattr(spinner, build)("circulant", **kw)
            params = pipe.init(gen)
            for f in FNAMES:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                est = estimators.estimate(pipe, params, f, v1, v2)
                torch.cuda.synchronize()
                t_card = time.perf_counter() - t0
                errs[(build, m, f)] = (est - closed[f]).abs().mean().item()
                if m != 4096:
                    continue
                with plain_route():
                    t0 = time.perf_counter()
                    plain = estimators.estimate(pipe, params, f, v1, v2)
                    torch.cuda.synchronize()
                    t_plain = time.perf_counter() - t0
                limit = 1e-4 * plain.abs().max().item()
                if f in STEP_F:
                    limit = limit + STEP_F[f] / m * (
                        _near_step(pipe, params, v1)
                        + _near_step(pipe, params, v2)).float()
                diff = (est - plain).abs()
                if not torch.isfinite(est).all() or (diff > limit).any():
                    raise AssertionError(
                        f"estimate {build} m={m} {f}: card route differs "
                        f"from the plain route by {diff.max().item():.3e}")
                worst = max(worst, diff.max().item())
                log(f"  estimate {build} m={m} {f}: mean|est-exact| "
                    f"{errs[(build, m, f)]:.5f} (m=256: "
                    f"{errs[(build, 256, f)]:.5f}); card {1e3 * t_card:.1f} "
                    f"ms, plain route {1e3 * t_plain:.1f} ms (host clock)")
    counts = ops.launch_counts()
    log(f"    launches (card routes): {counts}; max|card - plain| "
        f"{worst:.3e}")
    if counts["spinner"] <= 0 or counts["spinner_plain_on_cuda"]:
        raise AssertionError(f"estimators: spinner launches {counts}")
    for build in ("single", "hd_chain"):
        for f in FNAMES:
            if not errs[(build, 4096, f)] < errs[(build, 256, f)]:
                raise AssertionError(f"estimate {build} {f}: the error did "
                                     f"not fall from m=256 to m=4096")

    n = 128
    w = torch.randn((2, n), generator=gen, device=dev)
    w1, w2 = w / w.norm(dim=-1, keepdim=True)
    ops.reset_counts()
    log("    mc_error (kind, f, m, mean, std):")
    for kind in ("unstructured", "circulant", "toeplitz", "ldr"):
        for f in ("heaviside", "trig"):
            row = {}
            for m in (16, 64, 256, 1024):
                g = torch.Generator(device=dev).manual_seed(5)
                mean, std = estimators.mc_error(
                    g, spinner.single(kind, m=m, n=n, r=2), f, w1, w2,
                    n_trials=32)
                row[m] = (mean.item(), std.item())
            log(f"      {kind},{f}: " + "  ".join(
                f"m={m} {a:.5f}/{b:.5f}" for m, (a, b) in row.items()))
            if not row[1024][0] < row[16][0]:
                raise AssertionError(f"mc_error {kind} {f}: the error did "
                                     f"not fall from m=16 to m=1024")
    counts = ops.launch_counts()
    log(f"    mc_error launches: {counts} (ldr by the plain rule)")
    if counts["spinner"] <= 0 or \
            counts["spinner_plain_on_cuda"] != 2 * 4 * 32 * 2:
        raise AssertionError(f"mc_error: launches {counts}")


# ---------------------------------------------------------------------------
# phase 4: serve
# ---------------------------------------------------------------------------

def serve_args(attn=None, **kw):
    """The serve CLI's arguments: qwen3-4b, ``--attn`` only if given (the
    config's own ``full`` otherwise), then ``kw`` as flags."""
    from repro_torch.launch import serve
    argv = ["--arch", "qwen3-4b"] + (["--attn", attn] if attn else [])
    for k, v in kw.items():
        if v is False:
            continue
        argv += [f"--{k.replace('_', '-')}"] + ([] if v is True else [str(v)])
    return serve.parser().parse_args(argv)


# reduced card-vs-CPU agreement: (label, attn, dtype, --quantize-kv)
REDUCED = [("srf", "srf", "float32", False),
           ("full-KV bf16 pages", "full", "bfloat16", False),
           ("full-KV int8 pages", "full", "float32", True)]


def phase_reduced_agreement():
    """Reduced qwen3-4b served on the card and on the CPU (plain
    versions), with SRF state, bf16 KV pages and int8 KV pages: the
    greedy tokens must be equal."""
    from repro_torch.configs import registry
    from repro_torch.launch import serve
    from repro_torch.models import transformer as model_lib
    for label, attn, dtype, quant in REDUCED:
        cfg = registry.reduced("qwen3-4b", attn_impl=attn, dtype=dtype)
        params = model_lib.init(cfg, seed=3, device="cpu")
        out = {}
        for device in ("cpu", "cuda"):
            args = serve_args(attn, reduced=True, requests=8, prompt_len=24,
                              max_new=6, slots=4, max_len=64, seed=3,
                              device=device, quantize_kv=quant)
            res = serve.serve(args, cfg, _to(params, device))
            out[device] = {r.uid: r.out_tokens for r in res["done"]}
        if out["cpu"] != out["cuda"] or len(out["cuda"]) != 8:
            raise AssertionError(f"reduced {label}: greedy tokens differ "
                                 f"between card and CPU: {out}")
        log(f"  reduced qwen3-4b {label}: card tokens == CPU tokens "
            f"({sum(len(t) for t in out['cuda'].values())} tokens)")


def _seeded(cfg):
    """``cfg`` with seeded SRF projections (one seed per layer and kv
    head), as the reference's tests build it: ``registry.reduced``
    rebuilds ``srf`` and would drop the flag."""
    return dataclasses.replace(cfg, srf=dataclasses.replace(cfg.srf,
                                                            seeded=True))


def _personalize(reqs):
    """embed_seed 0 for uids 0-3, a distinct non-zero seed for uids 4-7
    (2**32 - 1 among them); odd uids sampled (temperature 0.8, top_k 40,
    top_p 0.95), even uids greedy."""
    for r in reqs:
        r.embed_seed = 0 if r.uid < 4 else (2 ** 32 - 1 if r.uid == 7
                                            else 1000 + r.uid)
        if r.uid % 2:
            r.temperature, r.top_k, r.top_p = 0.8, 40, 0.95
    return reqs


def phase_reduced_seeded_agreement():
    """Reduced seeded-SRF qwen3-4b with mixed embed seeds and mixed greedy
    / sampled requests (engine seed 3), on the card and on the CPU: the
    tokens must be equal."""
    from repro_torch.configs import registry
    from repro_torch.launch import serve
    from repro_torch.models import transformer as model_lib
    cfg = _seeded(registry.reduced("qwen3-4b", attn_impl="srf",
                                   dtype="float32"))
    params = model_lib.init(cfg, seed=3, device="cpu")
    out = {}
    for device in ("cpu", "cuda"):
        args = serve_args("srf", reduced=True, requests=8, prompt_len=24,
                          max_new=6, slots=4, max_len=64, seed=3,
                          device=device)
        res = serve.serve(args, cfg, _to(params, device),
                          reqs=_personalize(serve.requests(args, cfg)))
        out[device] = {r.uid: r.out_tokens for r in res["done"]}
    if out["cpu"] != out["cuda"] or len(out["cuda"]) != 8:
        raise AssertionError(f"reduced seeded SRF: tokens differ between "
                             f"card and CPU: {out}")
    log(f"  reduced qwen3-4b seeded SRF, mixed embed seeds, greedy + "
        f"sampled: card tokens == CPU tokens "
        f"({sum(len(t) for t in out['cuda'].values())} tokens)")


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_to(v, device) for v in tree)
    return tree.to(device)


SHARED = 96                       # prompt tokens the prefix run shares
TRAFFIC = dict(requests=8, prompt_len=128, max_new=32, slots=8,
               max_len=256, seed=0, device="cuda")


def _check_serve(label, res, args, counts, expect):
    """Every request finished with max_new tokens, every logit row is
    finite, and each kernel of ``expect`` launched exactly or at least
    as often as it says ({name: (n, exact)}); every other gather and
    the seeded spinner (kernel and plain route) 0."""
    eng = res["engine"]
    bad = [r.uid for r in res["done"] if len(r.out_tokens) != args.max_new]
    if len(res["done"]) != args.requests or bad:
        raise AssertionError(f"{label}: requests not finished with "
                             f"{args.max_new} tokens: {bad}")
    if eng.nonfinite_rows:
        raise AssertionError(f"{label}: {eng.nonfinite_rows} logit rows "
                             f"not finite")
    for name in ("paged_gather", "paged_gather_dequant", "spinner_seeded",
                 "spinner_seeded_plain_on_cuda", "fwht", "fwht_plain_on_cuda",
                 "circulant_project"):
        expect.setdefault(name, (0, True))
    for name, (n, is_exact) in expect.items():
        got = counts[name]
        if (got != n) if is_exact else (got < n):
            raise AssertionError(f"{label}: {name} launched {got} times, "
                                 f"expected {'' if is_exact else '>= '}{n}")
    if counts["spinner_plain_on_cuda"]:
        raise AssertionError(f"{label}: spinner calls on the card took the "
                             f"plain version")


def _serve_line(label, res, steps, peak):
    eng = res["engine"]
    log(f"  {label}: served {len(res['done'])} requests, {res['tokens']} "
        f"tokens in {res['wall_s']:.3f} s: {res['tok_s']:.1f} tok/s, TTFT "
        f"p50 {res['ttft_s']['p50']:.4f} s, {eng.stats['prefill_steps']} "
        f"prefill + {eng.stats['decode_steps']} decode steps ({steps} in "
        f"the counted run), peak memory {peak:.2f} GiB")


def _steps(eng):
    return int(eng.stats["prefill_steps"] + eng.stats["decode_steps"])


def _describe(cfg, params, t0):
    n_params = sum(t.numel() for t in _leaves(params))
    log(f"  full-width {cfg.name}: {cfg.n_layers} layers, d_model "
        f"{cfg.d_model}, {cfg.n_heads} q / {cfg.n_kv_heads} kv heads of "
        f"{cfg.head_dim}, {cfg.dtype}, {n_params / 1e9:.3f} B params, "
        f"attention {cfg.attn_impl}; init {time.perf_counter() - t0:.1f} s")


def phase_serve_kv():
    """Full-width qwen3-4b with its default full attention: bf16 KV
    pages, int8 KV pages, and the prefix cache (a cold wave of 8 prompts
    sharing their first 96 tokens, then the same 8 prompts warm, in one
    engine). Returns {run: launch counts}."""
    from repro_torch.kernels import ops
    from repro_torch.launch import serve
    args = serve_args(**TRAFFIC)
    t0 = time.perf_counter()
    cfg, params = serve.build(args)
    torch.cuda.synchronize()
    _describe(cfg, params, t0)
    per_step = 2 * cfg.n_layers
    out = {}
    for label, flags in (("bf16 pages", {}),
                         ("int8 pages", {"quantize_kv": True})):
        a = serve_args(**TRAFFIC, **flags)
        serve.warm(a, cfg, params)
        res = None                # free the previous run's engine first
        gc.collect()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_counts()
        res = serve.serve(a, cfg, params)
        counts = ops.launch_counts()
        steps = _steps(res["engine"])
        _serve_line(label, res, steps,
                    torch.cuda.max_memory_allocated() / 2 ** 30)
        log(f"    launches: {counts}")
        name = "paged_gather_dequant" if a.quantize_kv else "paged_gather"
        _check_serve(label, res, a, counts, {
            name: (per_step * steps, True), "spinner": (0, True),
            "srf_decode": (0, True)})
        out[label] = counts

    a = serve_args(**TRAFFIC, prefix_cache=True, shared_prefix=SHARED)
    serve.warm(a, cfg, params)
    res = None
    gc.collect()
    eng = serve.engine(a, cfg, params)
    torch.cuda.reset_peak_memory_stats()
    ops.reset_counts()
    cold = serve.serve(a, eng=eng)
    warm = serve.serve(a, eng=eng)
    counts = ops.launch_counts()
    steps = _steps(eng)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    _serve_line("prefix cache, cold + warm wave", warm, steps, peak)
    log(f"    cold wave {cold['tok_s']:.1f} tok/s, TTFT p50 "
        f"{cold['ttft_s']['p50']:.4f} s; warm wave {warm['tok_s']:.1f} "
        f"tok/s, TTFT p50 {warm['ttft_s']['p50']:.4f} s")
    log(f"    launches: {counts}")
    for res in (cold, warm):
        _check_serve("prefix cache", res, a, counts, {
            "paged_gather": (per_step * steps, True), "spinner": (0, True),
            "srf_decode": (0, True)})
    v = eng.metrics.value_sum
    stats = {c: int(v(c)) for c in (
        "prefix_lookups_total", "prefix_hits_total",
        "prefix_hit_tokens_total", "prefix_cow_forks_total",
        "prefix_evictions_total", "engine_prefill_tokens_total")}
    same = sum(a_.out_tokens == b_.out_tokens for a_, b_ in zip(
        sorted(cold["done"], key=lambda r: r.uid),
        sorted(warm["done"], key=lambda r: r.uid)))
    log(f"    prefix counters: {stats}")
    log(f"    greedy agreement warm vs cold: {same} of {a.requests} "
        f"requests with identical tokens (not asserted: bf16 matmuls on "
        f"other chunk shapes may flip near-ties)")
    if stats["prefix_hit_tokens_total"] <= 0:
        raise AssertionError("prefix cache: no prompt token was served "
                             "from the cache")
    alloc = eng.sched.alloc
    if alloc.used_pages != eng.prefix.pages or \
            alloc.total_refs != eng.prefix.pages:
        raise AssertionError(f"prefix cache: pages leaked: used "
                             f"{alloc.used_pages}, refs {alloc.total_refs}, "
                             f"cache {eng.prefix.pages}")
    eng.prefix.drop_all()
    if alloc.used_pages or alloc.total_refs:
        raise AssertionError("prefix cache: pages left after drop_all")
    out["prefix cache"] = counts
    return out


class count_probes:
    """Counts the live quality probe's calls inside the block (the
    engine looks the probe up in ``obs.quality`` at each call)."""

    def __enter__(self):
        from repro_torch.obs import quality
        self.calls, self.probe = 0, quality.srf_quality_probe

        def probe(*a, **k):
            self.calls += 1
            return self.probe(*a, **k)
        quality.srf_quality_probe = probe
        return self

    def __exit__(self, *exc):
        from repro_torch.obs import quality
        quality.srf_quality_probe = self.probe


def _check_probe(label, res, probes):
    """Exactly one probe sample in the run (the engine primes it for the
    first decode step; quality_every = 64 > 31 decode steps), both stats
    finite and under DRIFT_TOL in the engine's srf_quality gauge, no
    quality_drift event; prints the probe's host time, sync included."""
    from repro_torch.obs import quality
    eng = res["engine"]
    gauge = eng.metrics.snapshot()["gauges"].get("srf_quality", {})
    stats = {k.split('stat="')[1].rstrip('"'): v for k, v in gauge.items()}
    drift = [e for e in eng.metrics.events if e["event"] == "quality_drift"]
    if probes.calls != 1 or set(stats) != {"srf_row_mean_abs_max",
                                           "srf_row_var_err_max"}:
        raise AssertionError(f"{label}: {probes.calls} quality samples, "
                             f"gauge {stats}")
    if drift or not all(math.isfinite(v) and v < quality.DRIFT_TOL
                        for v in stats.values()):
        raise AssertionError(f"{label}: quality drifted: {stats}")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    quality.srf_quality_probe(eng.cfg, eng.params)
    ms = 1e3 * (time.perf_counter() - t0)
    log(f"    quality probe: 1 sample, {stats}, no drift; one probe "
        f"{ms:.2f} ms (host clock)")


def phase_serve_srf():
    """Full-width qwen3-4b with SRF attention, as in the first slice: the
    spinner and srf_decode kernels launch at least 72 per step and 36 per
    decode step, the gathers never."""
    from repro_torch.kernels import ops
    from repro_torch.launch import serve
    args = serve_args("srf", **TRAFFIC)
    t0 = time.perf_counter()
    cfg, params = serve.build(args)
    torch.cuda.synchronize()
    _describe(cfg, params, t0)
    serve.warm(args, cfg, params)
    torch.cuda.reset_peak_memory_stats()
    ops.reset_counts()
    with count_probes() as probes:
        res = serve.serve(args, cfg, params)
    counts = ops.launch_counts()
    eng = res["engine"]
    steps, dsteps = _steps(eng), int(eng.stats["decode_steps"])
    _serve_line("SRF", res, steps, torch.cuda.max_memory_allocated() / 2 ** 30)
    log(f"    launches: {counts}")
    _check_serve("SRF", res, args, counts, {
        "spinner": (2 * cfg.n_layers * steps, False),
        "srf_decode": (cfg.n_layers * dsteps, False)})
    _check_probe("SRF", res, probes)
    return counts


def phase_serve_seeded():
    """Full-width qwen3-4b with seeded SRF attention: per-request embed
    seeds and mixed greedy / sampled requests in one batch. The seeded
    spinner launches at least 72 per step, srf_decode exactly 36 per
    decode step, the materialized spinner, the seeded plain route and
    the gathers never."""
    from repro_torch.configs import registry
    from repro_torch.kernels import ops
    from repro_torch.launch import serve
    from repro_torch.models import transformer as model_lib
    args = serve_args("srf", **TRAFFIC)
    cfg = _seeded(registry.get("qwen3-4b", attn_impl="srf"))
    t0 = time.perf_counter()
    params = model_lib.init(cfg, seed=args.seed, device="cuda")
    torch.cuda.synchronize()
    _describe(cfg, params, t0)
    serve.warm(args, cfg, params)
    torch.cuda.reset_peak_memory_stats()
    ops.reset_counts()
    with count_probes() as probes:
        res = serve.serve(args, cfg, params,
                          reqs=_personalize(serve.requests(args, cfg)))
    counts = ops.launch_counts()
    eng = res["engine"]
    steps, dsteps = _steps(eng), int(eng.stats["decode_steps"])
    _serve_line("seeded SRF", res, steps,
                torch.cuda.max_memory_allocated() / 2 ** 30)
    log(f"    launches: {counts}")
    _check_serve("seeded SRF", res, args, counts, {
        "spinner_seeded": (2 * cfg.n_layers * steps, False),
        "srf_decode": (cfg.n_layers * dsteps, True), "spinner": (0, True),
        "spinner_seeded_plain_on_cuda": (0, True)})
    _check_probe("seeded SRF", res, probes)
    seeded_bytes = sum(t.numel() * t.element_size() for blk in
                       params["segments"][0]["attn"]["srf"]
                       for t in blk.values())
    pipe = _unseeded_pipeline(cfg)
    mat_bytes = (cfg.n_layers * cfg.n_kv_heads * pipe.storage
                 * torch.finfo(model_lib.dtype_of(cfg)).bits // 8)
    log(f"    SRF projection bytes: seeded {seeded_bytes} (one int64 seed "
        f"per layer and kv head) against {mat_bytes} materialized "
        f"({pipe.storage} {cfg.dtype} values per head)")
    sampled = [r.uid for r in res["done"] if r.temperature > 0]
    log(f"    sampled requests {sampled}, embed seeds "
        f"{[r.embed_seed for r in sorted(res['done'], key=lambda r: r.uid)]}")
    return counts


def _unseeded_pipeline(cfg):
    from repro_torch.models import attention as attn_lib
    return dataclasses.replace(attn_lib.srf_cfg(cfg), seeded=False).pipeline


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (tuple, list)):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def _record(name, source, replaces, launches, rec, shape):
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches,
            "max_abs_err": rec["err"], "ms": rec["ms"],
            "plain_ms": rec["plain_ms"], "bound_ms": rec["bound_ms"],
            "bound_by": rec["bound_by"],
            "library_ms": rec.get("library_ms"), "shape": shape}


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
    libs = build.build(["spinner", "srf_decode", "paged_gather", "fwht",
                        "circulant"])
    log(f"  built {sorted(libs)} in {time.perf_counter() - t0:.1f} s")

    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    log("phase 2: kernels against their plain versions")
    spin = phase_spinner(gen)
    seeded = phase_seeded_spinner(gen)
    dec = phase_srf_decode(gen)
    gather = phase_paged_gather(gen)
    fwht = phase_fwht(gen)
    circ = phase_circulant(gen)
    phase_sampler(gen)

    log("phase 3: the kernel-estimation library")
    phase_estimators(gen)
    gc.collect()
    torch.cuda.empty_cache()

    log("phase 4: serve")
    phase_reduced_agreement()
    phase_reduced_seeded_agreement()
    kv = phase_serve_kv()
    gc.collect()
    torch.cuda.empty_cache()
    srf = phase_serve_srf()
    gc.collect()
    torch.cuda.empty_cache()
    seeded_srf = phase_serve_seeded()

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    log(smi.stdout.strip().splitlines()[0])
    src = "src/repro_torch/kernels/csrc/"
    decode = "R=8, M=16, P=16, D=8*128, N=257, 36 layer pools cycled"
    kernels = [
        _record("spinner", src + "spinner.cu",
                "src/repro/kernels/spinner.py:111", srf["spinner"],
                spin[("decode query", torch.bfloat16)],
                "decode query: G=8, B=32, n=128, m=256, bf16, identity"),
        _record("srf_decode", src + "srf_decode.cu",
                "src/repro/kernels/srf_decode.py:26", srf["srf_decode"],
                dec, "B=8, H=32, m=256, dv=128, f32"),
        _record("paged_gather", src + "paged_gather.cu",
                "src/repro/kernels/paged_gather.py:28",
                kv["bf16 pages"]["paged_gather"],
                gather["decode"]["paged_gather"], decode + ", bf16"),
        _record("paged_gather_dequant", src + "paged_gather.cu",
                "src/repro/kernels/paged_gather.py:33",
                kv["int8 pages"]["paged_gather_dequant"],
                gather["decode"]["paged_gather_dequant"],
                decode + ", int8 -> bf16"),
        _record("seeded_spinner", src + "spinner.cu",
                "src/repro/kernels/spinner.py:249",
                seeded_srf["spinner_seeded"],
                seeded[("decode query", torch.bfloat16)],
                "decode query: G=64 (8 kv heads x 8 requests), B=4, n=128, "
                "m=256, bf16, identity"),
        _record("fwht", src + "fwht.cu", "src/repro/kernels/fwht.py:25",
                fwht["launches"], fwht,
                "B=8192, n=1024, f32, normalized; launches: phase_fwht's "
                "public-op run, (8192, 1024) and (4096, 16384) x f32, bf16"),
        _record("circulant_project", src + "circulant.cu",
                "src/repro/kernels/circulant.py:46", circ["launches"], circ,
                "g (4, 1024), x (8192, 1024), m=4096, f32, identity; "
                "launches: phase_circulant's public-op run, 5 epilogues x "
                "f32, bf16")]
    log(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
