"""Structured-JL gradient compression demo on the PyTorch port: train the
same tiny LM with exact vs compressed (+ error feedback) gradient
aggregation and compare loss curves + bytes on the wire. The port of
``examples/grad_compression_demo.py``.

(The cross-pod mean over a mesh runs in ``Trainer(mesh=...)`` with
``compress_dp``; here the compression math itself runs on one device.)

    PYTHONPATH=src python examples/torch_grad_compression_demo.py \\
        [--device cpu] [--steps 60]
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

from repro_torch import tree as tree_lib  # noqa: E402
from repro_torch.configs import registry  # noqa: E402
from repro_torch.data import synth  # noqa: E402
from repro_torch.data.loader import device_batch  # noqa: E402
from repro_torch.launch import steps as step_lib  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.optim import adamw, compression as C, schedule  # noqa: E402


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--steps", type=int, default=60)
    args = ap.parse_args(argv)
    cfg = registry.reduced("qwen3-4b", n_layers=2)
    params0 = T.init(cfg, seed=0, device=args.device)
    grad_fn = step_lib.make_grad_step(cfg)
    cc = C.CompressionConfig(chunk=4096, ratio=8, min_size=4096)

    def train(compressed: bool):
        params = T.requires_grad(tree_lib.map(
            lambda x: x.detach().clone(), params0))
        opt = adamw.init(params)
        err = C.init_error(params)
        losses = []
        for s in range(args.steps):
            batch = device_batch(synth.full_batch(cfg, 8, 64, s),
                                 args.device)
            grads, m = grad_fn(params, batch)
            if compressed:
                cct = C.CompressionConfig(chunk=4096, ratio=8,
                                          min_size=4096, seed=s)
                _, grads, err = C.roundtrip_with_feedback(grads, err, cct)
                grads = tree_lib.map(lambda g, p: g.to(p.dtype), grads,
                                     params)
            lr = schedule.warmup_cosine(s, 1e-2, 10, args.steps,
                                        device=args.device)
            params, opt, _ = adamw.update(grads, opt, params, lr)
            losses.append(float(m["loss"]))
        return losses

    exact = train(False)
    comp = train(True)
    raw, wire = C.wire_bytes(params0, cc)
    print(f"wire bytes/step: exact={raw/2**20:.1f} MiB  "
          f"compressed={wire/2**20:.1f} MiB  ({raw/wire:.1f}x reduction)")
    print(f"loss exact:      {exact[0]:.3f} -> {exact[-1]:.3f}")
    print(f"loss compressed: {comp[0]:.3f} -> {comp[-1]:.3f}")
    return {"raw": raw, "wire": wire, "exact": exact, "compressed": comp}


if __name__ == "__main__":
    main()
