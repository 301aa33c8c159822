"""The control of a cell's check, and the faults it must catch, read on
the card at the cell's own size (the benchmark's runs never run it):

    python3 portbench/control.py --workload qwen3-4b.rerank \
        --seeds 11 12 13 [--quant fp8]

prints one JSON line a seed with the numbers the check compares, the
reference put in the program's place at ``--quant`` (the precision
below the configuration's: float8 e4m3 for bfloat16)."""
import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--quant", default="fp8")
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import torch
    from portbench import bench
    if not torch.cuda.is_available():
        print("control: needs a CUDA device", file=sys.stderr)
        return 2
    cell = bench.find_cell(args.workload)
    drv = bench.driver(cell.traffic["kind"])
    for seed in args.seeds:
        t = time.perf_counter()
        nums = drv.control(cell, seed, torch.device("cuda", 0), args.quant)
        print(json.dumps({"workload": cell.name, "seed": seed,
                          "quant": args.quant, **nums,
                          "seconds": time.perf_counter() - t}), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
