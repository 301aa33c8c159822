"""Serving launcher for the port: the paged engine, the request router
over engine replicas (``--replicas``), or the legacy per-slot engine
(``--legacy``).

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-4b \
        [--attn full|srf] [--quantize-kv] [--prefix-cache \
        --cache-bytes 0 --chunk-tokens 0 --shared-prefix 0] \
        [--requests 16 --slots 8 --prompt-len 16 --max-new 24 \
        --max-len 128 --seed 0] [--temperature 0 --top-k 0 --top-p 1] \
        [--policy fcfs|priority] [--deadline S] \
        [--quality-every 64 --quality-tol 0.5] [--legacy] \
        [--replicas 1 --model-parallel 1 --ft --chaos KIND@STEP[:REPLICA]] \
        [--metrics --metrics-every 2 --metrics-out FILE] \
        [--kernel-timing] [--trace-out FILE] [--reduced] [--device cuda]

Full width is the default: ``--reduced`` opts into the tiny same-family
config of ``configs.registry.reduced``. ``--arch`` takes the dense
configs, ``mamba2-2.7b`` (SSD state in slots), ``hymba-1.5b``
(attention beside SSD state in every layer), ``moonshot-v1-16b-a3b``
(MoE), ``deepseek-v2-lite-16b`` (MLA latent pages, MoE), ``qwen2-vl-2b``
(served as a text LM with 1-D RoPE, as the reference serves it) and
``seamless-m4t-large-v2`` (enc-dec: each request gets its own synthetic
audio features, ``frontends.synthetic_audio_features`` drawn from the
request generator right after its prompt; the encoder runs once a
request at admission). Without ``--attn`` the
config's own attention serves (``full``: paged KV). Weights are random, drawn
from a ``torch.Generator`` seeded with ``--seed`` on the device; prompts
are random tokens from ``numpy.random.default_rng(--seed)``, the first
``--shared-prefix`` of them common to every request. ``--temperature``
0 decodes greedily; above 0 every request samples with ``--top-k`` and
``--top-p``, its noise keyed by ``--seed`` (the engine's seed), its uid
and the token's index. ``--policy priority`` admits by priority, each
request's drawn from 0-2 (after the prompts, from the same generator);
``--deadline S`` gives every request an S-second deadline, and a request
still waiting past it finishes as ``timeout``. An SRF engine publishes
the live quality probe (``srf_quality`` gauge) every ``--quality-every``
decode steps, the first decode step included.

``--legacy`` serves through the per-slot lock-step engine
(``serving/legacy.py``, the paged engine's test oracle) instead: one
batch-1 prefill per request, then one batch-1 decode call per active
slot and token; it records no spans and no periodic metrics, and takes
the same ``--seed`` for its sampling keys.

``--replicas N`` (N > 1) serves through ``serving.mesh.Router`` over N
paged engines on ``--device`` (all on the one card), engine i with seed
``--seed`` + i; they share one set of params and one metrics registry.
``--ft`` arms the fault-tolerant router (replica watchdog, quarantine,
rescue and replay of the quarantined replica's requests,
``serving/ft.py``), and ``--chaos KIND@STEP[:REPLICA]`` injects one
scripted fault (``raise``, ``hang``, ``reject`` or ``oom``; replica
default: the last) through the test-only harness ``serving/chaos.py``.
``--model-parallel W`` (W > 1) serves through the router over
``--replicas`` mesh-sharded engines (``Engine(mesh=...)``), one
('data', 'model') mesh of W devices each from
``launch.mesh.make_serving_meshes``: the visible cards, or with
``--device cpu`` CPU positions. Too few cards raise ``ValueError``, as
in the reference.

Telemetry: the engine (every replica, and the router) records into one
``obs.MetricsRegistry``.
``--metrics`` prints a one-line report every ``--metrics-every``
seconds of engine stepping and a final latency-percentile dump;
``--metrics-out FILE`` writes the Prometheus text exposition there (and
the event stream to ``FILE.events.jsonl``) with the final dump.
``--kernel-timing`` times every kernel dispatch into
``kernel_dispatch_seconds{kernel=...}``, synced before and after (it
serializes the card's queue; ``serving/README.md``). ``--trace-out
FILE`` records the span timeline of the engine (of every replica, and
one more of the router) and writes it as Chrome-trace JSON (Perfetto,
chrome://tracing).

The flags are the reference CLI's (``repro.launch.serve``) plus
``--device``. All output goes through ``obs.report.Reporter``: this
module and ``serving/`` print nothing themselves.
"""
from __future__ import annotations

import argparse
import copy
import sys
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch import obs
from repro_torch.configs import registry
from repro_torch.launch import mesh as mesh_lib
from repro_torch.models import frontends
from repro_torch.models import transformer as model_lib
from repro_torch.obs import export as trace_export
from repro_torch.obs import quality as quality_lib
from repro_torch.obs import spans as spans_lib
from repro_torch.obs import trace as obs_trace
from repro_torch.obs.report import Reporter
from repro_torch.serving import (Engine, FTConfig, PagedConfig, Request,
                                 Router)
from repro_torch.serving.prefix import ChunkConfig, PrefixConfig


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", required=True, choices=registry.ARCHS)
    ap.add_argument("--reduced", action="store_true",
                    help="tiny same-family config (default: full width)")
    ap.add_argument("--attn", default=None, choices=["full", "srf"])
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--slots", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--max-new", type=int, default=24)
    ap.add_argument("--max-len", type=int, default=128)
    ap.add_argument("--policy", default="fcfs", choices=["fcfs", "priority"])
    ap.add_argument("--quantize-kv", action="store_true",
                    help="int8 KV pages + per-page-row scales (kv family)")
    ap.add_argument("--prefix-cache", action="store_true",
                    help="radix prefix cache: requests sharing a cached "
                         "prompt prefix reuse its KV pages (COW) instead "
                         "of re-prefilling (serving/prefix)")
    ap.add_argument("--cache-bytes", type=int, default=0,
                    help="prefix-cache byte budget (0 = unbounded; LRU "
                         "eviction above the budget)")
    ap.add_argument("--chunk-tokens", type=int, default=0,
                    help="chunked-prefill token budget per step (0 = the "
                         "full step shape); long cold prompts admit in "
                         "chunks interleaved with decode")
    ap.add_argument("--shared-prefix", type=int, default=0,
                    help="synthetic prompts share their first N tokens")
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--top-k", type=int, default=0)
    ap.add_argument("--top-p", type=float, default=1.0)
    ap.add_argument("--deadline", type=float, default=None,
                    help="per-request deadline in seconds; overdue waiting "
                         "requests finish with reason 'timeout'")
    ap.add_argument("--quality-every", type=int, default=64,
                    help="decode steps between SRF row-gaussianity quality "
                         "samples (srf_quality gauge; 0 = off)")
    ap.add_argument("--quality-tol", type=float,
                    default=quality_lib.DRIFT_TOL,
                    help="row-moment drift tolerance; exceeding it "
                         "emits a quality_drift registry event")
    ap.add_argument("--legacy", action="store_true",
                    help="old per-slot engine (baseline, test oracle)")
    ap.add_argument("--replicas", type=int, default=1,
                    help="router-managed engine replicas (all on "
                         "--device)")
    ap.add_argument("--model-parallel", type=int, default=1,
                    help="model-axis TP width per replica (mesh-sharded "
                         "engines behind the router)")
    ap.add_argument("--ft", action="store_true",
                    help="fault-tolerant router: replica health watchdog "
                         "+ failover with request rescue (multi-replica)")
    ap.add_argument("--chaos", default=None, metavar="KIND@STEP[:REPLICA]",
                    help="test-only fault injection (kinds: raise|hang|"
                         "reject|oom), e.g. raise@6:1; needs --ft and "
                         "--replicas >= 2 to demonstrate recovery")
    ap.add_argument("--metrics", action="store_true",
                    help="periodic one-line metrics report + final "
                         "latency-percentile dump from the registry")
    ap.add_argument("--metrics-every", type=float, default=2.0,
                    help="seconds between periodic metrics lines")
    ap.add_argument("--metrics-out", default=None,
                    help="write Prometheus text exposition here "
                         "(+ .events.jsonl) at exit")
    ap.add_argument("--kernel-timing", action="store_true",
                    help="record per-dispatch kernel wall times (a sync "
                         "before and after every dispatch)")
    ap.add_argument("--trace-out", default=None, metavar="FILE",
                    help="record the engine's span timeline and write it "
                         "as Chrome-trace JSON here at exit")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    return ap


def config(args):
    """The model config the parsed arguments name."""
    overrides = {"attn_impl": args.attn} if args.attn else {}
    return (registry.reduced(args.arch, **overrides) if args.reduced
            else registry.get(args.arch, **overrides))


def build(args):
    """(cfg, params) for the parsed arguments."""
    cfg = config(args)
    return cfg, model_lib.init(cfg, seed=args.seed, device=args.device)


def requests(args, cfg) -> List[Request]:
    """``args.requests`` requests of ``args.prompt_len`` random tokens,
    the first ``args.shared_prefix`` common to all, decoded with
    ``args``' temperature, top-k and top-p, each with a priority in 0-2
    and ``args.deadline``; an enc-dec config's each with its own
    synthetic audio features, drawn after its prompt."""
    rng = np.random.default_rng(args.seed)
    common = rng.integers(0, cfg.vocab, max(args.shared_prefix, 0)
                          ).astype(np.int32)
    prompts, feats = [], []
    for _ in range(args.requests):
        prompt = rng.integers(0, cfg.vocab, args.prompt_len).astype(np.int32)
        k = min(len(common), args.prompt_len)
        prompt[:k] = common[:k]
        prompts.append(prompt)
        feats.append(frontends.synthetic_audio_features(rng, cfg)
                     if cfg.is_encdec else None)
    priorities = rng.integers(0, 3, args.requests)
    return [Request(uid=i, prompt=prompt, max_new=args.max_new,
                    priority=int(priorities[i]),
                    temperature=args.temperature, top_k=args.top_k,
                    top_p=args.top_p, deadline=args.deadline,
                    enc_emb=feats[i])
            for i, prompt in enumerate(prompts)]


def prefix_config(args) -> Optional[PrefixConfig]:
    if not (args.prefix_cache or args.cache_bytes or args.chunk_tokens):
        return None
    return PrefixConfig(cache_bytes=args.cache_bytes,
                        chunk=ChunkConfig(chunk_tokens=args.chunk_tokens))


def engine(args, cfg, params, metrics=None, spans=None, mesh=None):
    """The paged engine the arguments ask for (recording into
    ``metrics`` and ``spans`` when given; sharded over ``mesh`` when
    given), or with ``args.legacy`` the legacy per-slot engine (which
    records neither)."""
    if args.legacy:
        from repro_torch.serving import legacy
        return legacy.Engine(cfg, params, batch_slots=args.slots,
                             max_len=args.max_len, seed=args.seed,
                             device=args.device)
    return Engine(cfg, params, batch_slots=args.slots, max_len=args.max_len,
                  policy=args.policy, seed=args.seed, device=args.device,
                  paged=PagedConfig(quantize_kv=args.quantize_kv),
                  prefix=prefix_config(args),
                  quality_every=args.quality_every,
                  quality_tol=args.quality_tol, metrics=metrics,
                  spans=spans, mesh=mesh)


def router(args, cfg, params, metrics=None, recorders=None, rep=None,
           meshes=None):
    """``args.replicas`` paged engines (engine i seeded ``args.seed`` + i,
    sharded over ``meshes[i]`` when given, recording into
    ``recorders[i]`` when given) behind a ``Router`` that
    records into ``metrics`` and, past the replicas' recorders, into one
    recorder of its own; with ``args.ft`` fault-tolerant, and with
    ``args.chaos`` one replica wrapped in the test-only fault injector
    (announced on ``rep``)."""
    engines = []
    for i in range(args.replicas):
        a = copy.copy(args)
        a.seed = args.seed + i
        engines.append(engine(a, cfg, params, metrics=metrics,
                              spans=recorders[i] if recorders else None,
                              mesh=meshes[i] if meshes else None))
    if args.chaos:
        from repro_torch.serving.chaos import ChaosEngine, ChaosPlan
        spec, _, rep_s = args.chaos.partition(":")
        kind, _, step_s = spec.partition("@")
        rep_i = int(rep_s or (len(engines) - 1))
        engines[rep_i] = ChaosEngine(
            engines[rep_i], ChaosPlan(kind, at_step=int(step_s or 5)))
        if rep is not None:
            rep.line(f"[chaos] replica {rep_i}: {kind}@{step_s or 5} "
                     "(test-only fault injection)")
    if recorders:
        # the router's own spans (scoring, quarantine, rescue, replay)
        # merge as one more timeline row past the replicas' rows
        recorders.append(spans_lib.SpanRecorder(replica=len(engines)))
    return Router(engines, metrics=metrics,
                  ft=FTConfig() if args.ft else None,
                  spans=recorders[-1] if recorders else None)


def _replica0(eng):
    """The engine itself, or a router's first replica."""
    return eng.engines[0] if isinstance(eng, Router) else eng


def _ttft(r: Request) -> Optional[float]:
    """Submit to first token (the legacy engine keeps no trace)."""
    if r.trace is not None:
        return r.trace.ttft
    return r.t_first - r.t_submit if r.t_first else None


def serve(args, cfg=None, params=None, eng=None,
          reqs: Optional[List[Request]] = None, on_step=None) -> Dict:
    """Serve ``reqs`` (by default ``requests(args, cfg)``) on ``eng`` (an
    engine or a ``Router``) if given, else on a new engine (``engine``);
    returns the finished requests, the engine and the measured wall
    time, tokens/s and TTFT. ``on_step`` goes to the paged engine's or
    the router's ``run``."""
    if eng is None:
        if cfg is None:
            cfg, params = build(args)
        eng = engine(args, cfg, params)
    cfg, device = _replica0(eng).cfg, _replica0(eng).device
    if reqs is None:
        reqs = requests(args, cfg)
    t0 = time.perf_counter()
    for r in reqs:
        eng.submit(r)
    done = eng.run() if on_step is None else eng.run(on_step=on_step)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    wall = time.perf_counter() - t0
    tokens = sum(len(r.out_tokens) for r in done)
    ttft = obs_trace.percentiles([t for t in map(_ttft, done)
                                  if t is not None], (50, 95))
    return {"cfg": cfg, "engine": eng, "done": done, "wall_s": wall,
            "tokens": tokens, "tok_s": tokens / wall, "ttft_s": ttft}


def warm(args, cfg, params) -> None:
    """Serve 2 short requests (16 prompt tokens, 2 new) with ``args``'
    slots and lengths, so that one-time set-up costs (library handles,
    the allocator's first blocks) fall outside a measured run."""
    w = copy.copy(args)
    w.requests, w.prompt_len, w.max_new, w.seed = 2, 16, 2, args.seed + 1
    serve(w, cfg, params)


def main(argv: Optional[List[str]] = None) -> int:
    ap = parser()
    args = ap.parse_args(argv)
    routed = (args.replicas > 1 or args.model_parallel > 1) \
        and not args.legacy
    meshes = (mesh_lib.make_serving_meshes(args.replicas,
                                           args.model_parallel,
                                           device=args.device)
              if routed and args.model_parallel > 1 else None)
    rep = Reporter()
    metrics = obs.MetricsRegistry()
    tracing = args.trace_out is not None and not args.legacy
    recorders = ([spans_lib.SpanRecorder(replica=i)
                  for i in range(max(args.replicas, 1) if routed else 1)]
                 if tracing else [])
    if args.kernel_timing:
        obs.enable_kernel_timing(metrics)
    try:
        cfg, params = build(args)
        if routed:
            eng = router(args, cfg, params, metrics=metrics,
                         recorders=recorders, rep=rep, meshes=meshes)
        else:
            eng = engine(args, cfg, params, metrics=metrics,
                         spans=recorders[0] if tracing else None)
        on_step = (rep.periodic(metrics, every_s=args.metrics_every)
                   if args.metrics and not args.legacy else None)
        res = serve(args, eng=eng, on_step=on_step)
    finally:
        if args.kernel_timing:
            obs.disable_kernel_timing()
    done = res["done"]
    kind = "legacy" if args.legacy else "router" if routed else "paged"
    rep.line(f"arch={args.arch} attn={cfg.attn_impl} engine={kind} "
             f"reduced={args.reduced} device={_replica0(eng).device} "
             f"requests={len(done)} tokens={res['tokens']} "
             f"wall={res['wall_s']:.3f}s tok/s={res['tok_s']:.1f} "
             f"ttft_p50={res['ttft_s']['p50']:.4f}s")
    if routed:
        rep.line(f"  router: {eng.describe()}")
        rep.line(f"  replica0 report: {eng.engines[0].cache_report()}")
    elif not args.legacy:
        rep.line(f"  sched: {dict(eng.sched.stats)}  "
                 f"report: {eng.cache_report()}")
    if not args.legacy and _replica0(eng).prefix is not None:
        v = metrics.value_sum
        rep.line(f"  prefix: hits={int(v('prefix_hits_total'))} "
                 f"hit_tokens={int(v('prefix_hit_tokens_total'))} "
                 f"cow_forks={int(v('prefix_cow_forks_total'))} "
                 f"evictions={int(v('prefix_evictions_total'))} "
                 f"cache_bytes={int(v('prefix_cache_bytes'))}")
    for r in done[:3]:
        rep.line(f"  req{r.uid}: finish={r.finish_reason or 'done'} "
                 f"out={r.out_tokens[:8]}...")
    if args.metrics or args.metrics_out:
        rep.final(metrics, done, dump_path=args.metrics_out)
    if tracing:
        n = trace_export.dump_chrome_trace(args.trace_out, recorders)
        spans = sum(len(r) for r in recorders)
        dropped = sum(r.dropped for r in recorders)
        rep.line(f"[trace] {args.trace_out}: {n} events from {spans} "
                 f"spans across {len(recorders)} timelines"
                 + (f" ({dropped} dropped)" if dropped else ""))
    if args.kernel_timing and not metrics.snapshot()["histograms"].get(
            "kernel_dispatch_seconds"):
        rep.line("[metrics] kernel-timing: no kernel dispatches recorded "
                 "(this run's path called none of kernels/ops.py)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
