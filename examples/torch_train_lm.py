"""End-to-end driver on the PyTorch port: train an LM with the full
production stack (sharded synthetic data, AdamW + cosine schedule,
atomic checkpoints with auto-resume, straggler watchdog) on a reduced
config. The port of ``examples/train_lm.py``.

The same Trainer drives full-size configs on the card; pass
--arch/--steps to taste. With --attn srf the model trains with the
paper's structured random-feature attention end to end (on the card:
the spinner kernel forward, its plain VJP backward).

    PYTHONPATH=src python examples/torch_train_lm.py [--steps 200] \\
        [--attn srf] [--device cpu]
"""
import argparse
import os
import sys
import tempfile

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

from repro_torch import tree as tree_lib  # noqa: E402
from repro_torch.configs import registry  # noqa: E402
from repro_torch.launch.steps import TrainHyper  # noqa: E402
from repro_torch.train.trainer import Trainer, TrainerConfig  # noqa: E402


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-4b")
    ap.add_argument("--steps", type=int, default=120)
    ap.add_argument("--attn", default="full", choices=["full", "srf"])
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_example_ckpt"))
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = registry.reduced(args.arch, attn_impl=args.attn, n_layers=2)
    tcfg = TrainerConfig(
        num_steps=args.steps, batch=args.batch, seq=args.seq,
        ckpt_dir=args.ckpt_dir, ckpt_every=40, log_every=10,
        hyper=TrainHyper(lr=1e-2, warmup=20, total_steps=args.steps),
        device=args.device)
    tr = Trainer(cfg, tcfg)
    resumed = tr.try_resume()
    n_params = sum(x.numel() for x in tree_lib.leaves(tr.params))
    print(f"arch={args.arch} attn={args.attn} params={n_params:,} "
          f"resumed={resumed}")
    out = tr.train()
    first, last = out["log"][0], out["log"][-1]
    print(f"step {first['step']}: loss={first['loss']:.3f}  ->  "
          f"step {last['step']}: loss={last['loss']:.3f}")
    if not last["loss"] < first["loss"]:
        raise AssertionError("loss should decrease")
    print("checkpoints:", tr.ckpt.available_steps())
    return out


if __name__ == "__main__":
    main()
