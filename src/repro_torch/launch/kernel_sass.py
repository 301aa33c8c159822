"""Show what nvcc made of one CUDA source of the port: ptxas's report
(registers, stack frame, spills, shared memory) and, per kernel, counts of
the SASS instructions that say how it touches memory.

    python src/repro_torch/launch/kernel_sass.py paged_gather \
        [--match dequant] [--src DIR] [--out build/paged_gather.sass]

Builds ``csrc/<name>.cu`` with the port's own flags (``build.NVCC_FLAGS``)
plus ``-Xptxas -v`` into ``build/kernels/`` and disassembles it with
``cuobjdump -sass``. ``--match`` keeps the kernels whose (mangled) name
holds the string; ``--src`` names the ``src`` directory whose
``repro_torch`` is built (another checkout, unpacked with ``git archive``
into a directory that .gitignore lists); ``--out`` writes the whole SASS.
Needs the CUDA toolkit (``nvcc``, ``cuobjdump``); no card.

Per kernel it prints one JSON line: the instruction count, local memory
accesses (``LDL`` / ``STL``: a stack frame in use), calls (``CALL``, with
the subroutines named: a 64-bit integer division is one), and the global
and shared loads and stores by width (``STG.E.128`` is one 16-byte store
a thread).
"""
from __future__ import annotations

import argparse
import collections
import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

_FUNC = re.compile(r"^\s*Function : (\S+)", re.M)
_INSN = re.compile(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)")
_CALL = re.compile(r"CALL\.\S+\s+(?:`\()?([^`)\s;]+)")
_KEEP = ("LDL", "STL", "LDG", "STG", "LDS", "STS", "UBLKCP", "SYNCS", "BAR",
         "CALL", "I2F", "F2F", "F2FP", "FMUL", "FFMA")


def sass_by_function(text: str):
    """{mangled name: SASS text of that function} from cuobjdump's output."""
    heads = list(_FUNC.finditer(text))
    return {m.group(1): text[m.end():(heads[i + 1].start()
                                      if i + 1 < len(heads) else len(text))]
            for i, m in enumerate(heads)}


def summarize(body: str):
    """Instruction counts of one function: total, and by opcode for the
    memory, call, conversion and multiply families (full opcode with its
    modifiers, e.g. ``STG.E.128``)."""
    ops = _INSN.findall(body)
    hist = collections.Counter(op for op in ops if op.split(".")[0] in _KEEP)
    return {"instructions": len(ops), "ops": dict(sorted(hist.items())),
            "calls": sorted(set(_CALL.findall(body)))}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("name", help="csrc/<name>.cu")
    ap.add_argument("--match", default="")
    ap.add_argument("--src", default=str(Path(__file__).resolve().parents[2]))
    ap.add_argument("--out")
    args = ap.parse_args()
    sys.path.insert(0, str(Path(args.src).resolve()))
    from repro_torch.kernels import build
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    lib = build.BUILD_DIR / f"sass-{args.name}.so"
    cmd = build._command(args.name, lib)
    proc = subprocess.run(cmd[:1] + ["-Xptxas", "-v"] + cmd[1:],
                          capture_output=True, text=True)
    report = proc.stdout + proc.stderr
    if proc.returncode != 0:
        print(report, file=sys.stderr)
        return proc.returncode
    for block in re.split(r"(?=ptxas info\s+: Compiling entry function)",
                          report):
        if args.match in block and "Compiling entry" in block:
            print(block.rstrip())
    cuobjdump = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([cuobjdump, "-sass", str(lib)], capture_output=True,
                          text=True, check=True).stdout
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(sass)
    for name, body in sass_by_function(sass).items():
        if args.match in name:
            print(json.dumps({"kernel": name, **summarize(body)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
