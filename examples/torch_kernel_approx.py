"""Paper reproduction figure (as CSV) on the PyTorch port: kernel-
approximation error vs embedding dim m, for each structure class; the
error should fall ~1/sqrt(m) with structured classes tracking the
unstructured baseline (Thm 10-12). The port of
``examples/kernel_approx.py``.

    PYTHONPATH=src python examples/torch_kernel_approx.py [--device cpu] \\
        > kernel_approx.csv

On the card (the default ``--device cuda``) each estimate runs the
spinner kernel (kind ``ldr`` its plain version, as the reference's
Pallas route refuses it).
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import torch  # noqa: E402

from repro_torch.core import estimators as E  # noqa: E402
from repro_torch.core import spinner  # noqa: E402

KINDS = ["unstructured", "circulant", "toeplitz", "ldr"]
FNAMES = ["heaviside", "trig"]
MS = [16, 64, 256, 1024]


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--trials", type=int, default=32)
    args = ap.parse_args(argv)
    dev = torch.device(args.device)
    n = 128
    gen = torch.Generator(device=dev).manual_seed(1)
    v1 = torch.randn(n, generator=gen, device=dev)
    v1 = v1 / torch.linalg.norm(v1)
    v2 = torch.randn(n, generator=gen, device=dev)
    v2 = v2 / torch.linalg.norm(v2)
    rows = {}
    print("kind,f,m,mean_abs_err,std")
    with torch.no_grad():
        for kind in KINDS:
            for fname in FNAMES:
                for m in MS:
                    pipe = spinner.single(kind, m=m, n=n, r=2)
                    mean, std = E.mc_error(
                        torch.Generator(device=dev).manual_seed(5), pipe,
                        fname, v1, v2, n_trials=args.trials)
                    rows[(kind, fname, m)] = (float(mean), float(std))
                    print(f"{kind},{fname},{m},{float(mean):.5f},"
                          f"{float(std):.5f}")
    return rows


if __name__ == "__main__":
    main()
