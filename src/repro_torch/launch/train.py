"""Training launcher for the port.

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-4b \
        [--reduced] [--steps 100 --batch 8 --seq 64 --lr 3e-4 --seed 0] \
        [--ckpt-dir DIR --ckpt-every 50] [--attn full|srf [--seeded-srf]] \
        [--metrics-out FILE] [--device cuda|cpu]

The reference CLI's flags (``repro.launch.train``) plus ``--device`` and
``--seeded-srf`` (SRF projections regenerated from one seed per layer
and kv head instead of learned ``g``, ``d0``, ``d1``). Every config of
the registry trains: qwen2-vl-2b on batches with a vision prefix (the
synthetic patch features through the adapter, unlabelled, and M-RoPE
over ``pos3``), seamless-m4t-large-v2 on batches with encoder features.
Full width is the default (``--reduced`` opts into the tiny same-family
config): on one card that is qwen3-4b's 4.4 B params with bf16 grads
and f32 AdamW moments, about 53 GB. It runs on the card unless
``--device cpu`` is given; without a card ``--device cuda`` fails.
Weights are random from ``--seed``; the data is the synthetic stream
of ``data.synth``. Resumes from the latest committed checkpoint in
``--ckpt-dir`` (default: ``repro_torch_ckpt`` in the temporary
directory). ``--compress-dp`` is accepted and, as in the reference's
CLI, which builds no mesh, trains plainly (``Trainer(mesh=...)`` runs
the compressed cross-pod mean). All output goes through
``obs.report.Reporter``.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import tempfile
from typing import List, Optional

import torch

from repro_torch.configs import registry
from repro_torch.launch.steps import TrainHyper
from repro_torch.obs.report import Reporter
from repro_torch.train.trainer import Trainer, TrainerConfig


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", required=True, choices=registry.ARCHS)
    ap.add_argument("--reduced", action="store_true",
                    help="tiny same-family config (default: full width)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--attn", default=None, choices=["full", "srf"])
    ap.add_argument("--seeded-srf", action="store_true",
                    help="seeded SRF projections (needs --attn srf)")
    ap.add_argument("--compress-dp", action="store_true",
                    help="structured-JL compressed cross-pod gradients "
                         "(no mesh here: trains plainly, as the reference)")
    ap.add_argument("--metrics-out", default=None)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    return ap


def trainer(args) -> Trainer:
    overrides = {"attn_impl": args.attn} if args.attn else {}
    cfg = (registry.reduced if args.reduced else registry.get)(
        args.arch, **overrides)
    if args.seeded_srf:
        cfg = dataclasses.replace(cfg, srf=dataclasses.replace(
            cfg.srf, seeded=True))
    tcfg = TrainerConfig(
        num_steps=args.steps, batch=args.batch, seq=args.seq, seed=args.seed,
        ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every,
        hyper=TrainHyper(lr=args.lr, warmup=min(50, args.steps // 5 + 1),
                         total_steps=args.steps),
        compress_dp=args.compress_dp, device=args.device)
    return Trainer(cfg, tcfg)


def main(argv: Optional[List[str]] = None) -> int:
    ap = parser()
    args = ap.parse_args(argv)
    if args.seeded_srf and args.attn != "srf":
        ap.error("--seeded-srf needs --attn srf")
    if args.device == "cuda" and not torch.cuda.is_available():
        ap.error("--device cuda: no CUDA device (pass --device cpu)")
    rep = Reporter()
    tr = trainer(args)
    resumed = tr.try_resume()
    rep.line(f"arch={args.arch} attn={tr.cfg.attn_impl} "
             f"seeded_srf={args.seeded_srf} "
             f"params={tr.cfg.param_count():,} device={args.device} "
             f"resumed={resumed} start_step={tr.step}")
    out = tr.train()
    for rec in out["log"]:
        rep.line(json.dumps(rec))
    if args.metrics_out:
        with open(args.metrics_out, "w") as f:
            json.dump(out, f, indent=2)
    return 0


if __name__ == "__main__":
    sys.exit(main())
