"""Serving launcher for the port: the paged engine with SRF attention.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-4b \
        --attn srf [--requests 16 --slots 8 --prompt-len 16 --max-new 24 \
        --max-len 128 --seed 0] [--reduced] [--device cuda]

Full width is the default: ``--reduced`` opts into the tiny same-family
config of ``configs.registry.reduced``. Weights are random, drawn from a
``torch.Generator`` seeded with ``--seed`` on the device; prompts are
random tokens from ``numpy.random.default_rng(--seed)``. Decoding is
greedy. The flags are the reference CLI's (``repro.launch.serve``) for
this slice, plus ``--device``; the port serves ``--attn srf`` only.
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
from repro_torch.obs import trace as obs_trace
from repro_torch.serving import Engine, Request


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
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    return ap


def build(args):
    """(cfg, params) for the parsed arguments."""
    overrides = {"attn_impl": args.attn} if args.attn else {}
    cfg = (registry.reduced(args.arch, **overrides) if args.reduced
           else registry.get(args.arch, **overrides))
    return cfg, model_lib.init(cfg, seed=args.seed, device=args.device)


def requests(args, cfg) -> List[Request]:
    rng = np.random.default_rng(args.seed)
    return [Request(uid=i, prompt=rng.integers(0, cfg.vocab, args.prompt_len
                                               ).astype(np.int32),
                    max_new=args.max_new)
            for i in range(args.requests)]


def serve(args, cfg=None, params=None) -> Dict:
    """Serve ``args.requests`` requests; returns the finished requests,
    the engine and the measured wall time, tokens/s and TTFT."""
    if cfg is None:
        cfg, params = build(args)
    eng = Engine(cfg, params, batch_slots=args.slots, max_len=args.max_len,
                 device=args.device)
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
    for r in res["done"][:3]:
        print(f"  req{r.uid}: out={r.out_tokens[:8]}...")
    return 0


if __name__ == "__main__":
    sys.exit(main())
