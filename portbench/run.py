"""Run one cell of ``BENCHMARK.json`` once, on the machine it starts on:

    python3 portbench/run.py --workload qwen3-4b.rerank --seed 7 \
        --seconds 30 --trace 0

from the root of a checkout. It prints, as the last line of standard
output, one JSON object: ``correct``, ``attempted``, ``failed``, the
cell's end-to-end metrics (``--trace 0``) or its per-layer metrics
(``--trace 1``, with the device's busy seconds and a breakdown), the
device, and last ``check``: each compared number beside its limit,
which are also the last lines of standard error. It exits non-zero and
prints no result when there is no card, too few cards, no program
beside it, or a JAX module loaded."""
import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap


def main(argv=None) -> int:
    args = _parser().parse_args(argv)
    # the port builds its kernels with nvcc into build/kernels/ of this
    # checkout (repro_torch/kernels/build.py): a fixed path, built once
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    from portbench import bench
    cell = bench.find_cell(args.workload)
    import torch
    if not torch.cuda.is_available() \
            or torch.cuda.device_count() < cell.chips:
        print(f"run: {args.workload} needs {cell.chips} CUDA device(s); "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    torch.set_num_threads(2)
    drv = bench.driver(cell.traffic["kind"])
    device = torch.device("cuda", 0)
    record = drv.run(cell, args.seed, args.seconds, bool(args.trace),
                     device, T_PROCESS)
    bad = bench.forbidden_modules()
    if bad:
        print(f"run: modules of JAX or of the JAX package were loaded: "
              f"{bad}", file=sys.stderr)
        return 3
    device_info = {"platform": "gpu",
                   "kind": torch.cuda.get_device_name(device),
                   "count": cell.chips}
    result = bench.result(cell, record, bool(args.trace), device_info)
    for line in bench.check_lines(record, result.check):
        print(line, file=sys.stderr)
    print(result.line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
