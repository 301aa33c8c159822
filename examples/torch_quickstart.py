"""Quickstart on the PyTorch port: the paper's pipeline in 30 lines, on
the Spinner API (the port of ``examples/quickstart.py``).

Estimate three kernels with a circulant 1-block SpinnerPipeline using n
Gaussians instead of m*n, show the budget knob (circulant -> toeplitz ->
unstructured), then stack blocks (TripleSpin-style): same protocol,
same estimator, three fused dispatches.

    PYTHONPATH=src python examples/torch_quickstart.py [--device cpu]

On the card (the default ``--device cuda``) every projection is one
launch of the spinner kernel; on the CPU its plain version runs.
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import torch  # noqa: E402

from repro_torch.core import estimators as E  # noqa: E402
from repro_torch.core import spinner  # noqa: E402


def unit(gen, n, device):
    v = torch.randn(n, generator=gen, device=device)
    return v / torch.linalg.norm(v)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = torch.device(args.device)
    gen = torch.Generator(device=dev).manual_seed(1)
    n, m = 128, 512
    v1 = unit(gen, n, dev)
    v2 = 0.6 * v1 + 0.8 * torch.randn(n, generator=gen, device=dev)
    v2 = v2 / torch.linalg.norm(v2)

    out = {"budgets": {}, "errors": {}}
    print(f"input dim n={n}, embedding dim m={m}")
    with torch.no_grad():
        for kind in ["circulant", "toeplitz", "unstructured"]:
            pipe = spinner.single(kind, m=m, n=n)
            params = pipe.init(torch.Generator(device=dev).manual_seed(0))
            out["budgets"][kind] = pipe.budget
            print(f"\n[{kind}] budget of randomness t={pipe.budget} "
                  f"(dense would use {m*n}); storage={pipe.storage} floats")
            for fname in ["heaviside", "relu", "trig", "softmax"]:
                est = float(E.estimate(pipe, params, fname, v1, v2))
                ex = float(E.exact(fname, v1, v2))
                out["errors"][(kind, fname)] = abs(est - ex)
                print(f"  {fname:10s} estimate={est:+.4f}  exact={ex:+.4f}  "
                      f"|err|={abs(est-ex):.4f}")

        # stacked spinners: HD3.HD2.HD1 (depth 3): the same estimator runs
        # through a chain of fused blocks; storage stays O(n) per block.
        pipe3 = spinner.hd_chain("circulant", n=n, m=m, depth=3)
        params3 = pipe3.init(torch.Generator(device=dev).manual_seed(0))
        out["budgets"]["circulant x3"] = pipe3.budget
        print(f"\n[circulant x3 stacked] t={pipe3.budget}, "
              f"storage={pipe3.storage} floats, depth={pipe3.depth}")
        for fname in ["heaviside", "trig"]:
            est = float(E.estimate(pipe3, params3, fname, v1, v2))
            print(f"  {fname:10s} estimate={est:+.4f}")
    return out


if __name__ == "__main__":
    main()
