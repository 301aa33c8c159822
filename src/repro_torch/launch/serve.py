"""Serving launcher for the port: the paged engine.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-4b \
        [--attn full|srf] [--quantize-kv] [--prefix-cache \
        --cache-bytes 0 --chunk-tokens 0 --shared-prefix 0] \
        [--requests 16 --slots 8 --prompt-len 16 --max-new 24 \
        --max-len 128 --seed 0] [--temperature 0 --top-k 0 --top-p 1] \
        [--quality-every 64 --quality-tol 0.5] [--reduced] [--device cuda]

Full width is the default: ``--reduced`` opts into the tiny same-family
config of ``configs.registry.reduced``. Without ``--attn`` the config's
own attention serves (``full``: paged KV). Weights are random, drawn
from a ``torch.Generator`` seeded with ``--seed`` on the device; prompts
are random tokens from ``numpy.random.default_rng(--seed)``, the first
``--shared-prefix`` of them common to every request. ``--temperature``
0 decodes greedily; above 0 every request samples with ``--top-k`` and
``--top-p``, its noise keyed by ``--seed`` (the engine's seed), its uid
and the token's index. An SRF engine publishes the live quality probe
(``srf_quality`` gauge) every ``--quality-every`` decode steps, the
first decode step included. The flags are the reference CLI's
(``repro.launch.serve``) for what the port serves, plus ``--device``.
"""
from __future__ import annotations

import argparse
import copy
import sys
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.configs import registry
from repro_torch.models import transformer as model_lib
from repro_torch.obs import quality as quality_lib
from repro_torch.obs import trace as obs_trace
from repro_torch.serving import Engine, PagedConfig, Request
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
    ap.add_argument("--quality-every", type=int, default=64,
                    help="decode steps between SRF row-gaussianity quality "
                         "samples (srf_quality gauge; 0 = off)")
    ap.add_argument("--quality-tol", type=float,
                    default=quality_lib.DRIFT_TOL,
                    help="row-moment drift tolerance; exceeding it "
                         "emits a quality_drift registry event")
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
    ``args``' temperature, top-k and top-p."""
    rng = np.random.default_rng(args.seed)
    common = rng.integers(0, cfg.vocab, max(args.shared_prefix, 0)
                          ).astype(np.int32)
    out = []
    for i in range(args.requests):
        prompt = rng.integers(0, cfg.vocab, args.prompt_len).astype(np.int32)
        k = min(len(common), args.prompt_len)
        prompt[:k] = common[:k]
        out.append(Request(uid=i, prompt=prompt, max_new=args.max_new,
                           temperature=args.temperature, top_k=args.top_k,
                           top_p=args.top_p))
    return out


def prefix_config(args) -> Optional[PrefixConfig]:
    if not (args.prefix_cache or args.cache_bytes or args.chunk_tokens):
        return None
    return PrefixConfig(cache_bytes=args.cache_bytes,
                        chunk=ChunkConfig(chunk_tokens=args.chunk_tokens))


def engine(args, cfg, params) -> Engine:
    return Engine(cfg, params, batch_slots=args.slots, max_len=args.max_len,
                  seed=args.seed, device=args.device,
                  paged=PagedConfig(quantize_kv=args.quantize_kv),
                  prefix=prefix_config(args),
                  quality_every=args.quality_every,
                  quality_tol=args.quality_tol)


def serve(args, cfg=None, params=None, eng: Optional[Engine] = None,
          reqs: Optional[List[Request]] = None) -> Dict:
    """Serve ``reqs`` (by default ``requests(args, cfg)``) on ``eng`` if
    given, else on a new engine; returns the finished requests, the
    engine and the measured wall time, tokens/s and TTFT."""
    if eng is None:
        if cfg is None:
            cfg, params = build(args)
        eng = engine(args, cfg, params)
    cfg = eng.cfg
    if reqs is None:
        reqs = requests(args, cfg)
    t0 = time.perf_counter()
    for r in reqs:
        eng.submit(r)
    done = eng.run()
    if eng.device.type == "cuda":
        torch.cuda.synchronize(eng.device)
    wall = time.perf_counter() - t0
    tokens = sum(len(r.out_tokens) for r in done)
    ttft = obs_trace.percentiles([r.trace.ttft for r in done], (50, 95))
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
    args = parser().parse_args(argv)
    res = serve(args)
    eng = res["engine"]
    print(f"arch={args.arch} attn={res['cfg'].attn_impl} "
          f"reduced={args.reduced} device={eng.device} "
          f"requests={len(res['done'])} tokens={res['tokens']} "
          f"wall={res['wall_s']:.3f}s tok/s={res['tok_s']:.1f} "
          f"ttft_p50={res['ttft_s']['p50']:.4f}s")
    print(f"  sched: {dict(eng.sched.stats)}  report: {eng.cache_report()}")
    if eng.prefix is not None:
        v = eng.metrics.value_sum
        print(f"  prefix: hits={int(v('prefix_hits_total'))} "
              f"hit_tokens={int(v('prefix_hit_tokens_total'))} "
              f"cow_forks={int(v('prefix_cow_forks_total'))} "
              f"evictions={int(v('prefix_evictions_total'))} "
              f"cache_bytes={int(v('prefix_cache_bytes'))}")
    for r in res["done"][:3]:
        print(f"  req{r.uid}: out={r.out_tokens[:8]}...")
    return 0


if __name__ == "__main__":
    sys.exit(main())
