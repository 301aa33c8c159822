"""What each kernel's function needs: its operations and the bytes it
must move, as ``(ops, bytes)``. One definition serves the card's bound
(``chip_smoke.bound``: the larger of bytes over the HBM rate and
operations over the f32 peak) and the cost analysis of a step
(``launch.cost_analysis``), where every dispatcher of ``kernels/ops.py``
adds its kernel's count by these formulas.

Bytes: each input read once, each output written once, whatever the
kernel reads again. Operations: the function's own (FFT products, the
HD butterfly, the seeded draws, the SRF update and readout; f32 and
integer work of the CUDA cores), not what the kernel does (the spinner
kernels regenerate A and take B*m*n multiply-adds on the tensor cores).
"""
from __future__ import annotations

import math
from typing import Tuple

from repro_torch.core import structured

# operations counted per generated value of the seeded spinner: one
# threefry2x32 call is 20 rounds of (add, rotate = 2 shifts + or, xor)
# plus 5 key injections of 3 adds: 115 integer operations; the
# Box-Muller step adds 2 mantissa fills (3 each), 2 subtractions, a
# multiply and log, sqrt and cos, counted as 10 each: 40. A sign is one
# cipher call and a compare.
OPS_PER_NORMAL = 115 + 40
OPS_PER_SIGN = 115 + 1


def gen_elems(kind: str, n: int, m: int) -> int:
    """A generator's canonical size: nb*n for (skew) circulant, n+m-1 for
    toeplitz / hankel, m*n dense."""
    return {"circulant": -(-m // n) * n, "skew_circulant": -(-m // n) * n,
            "toeplitz": n + m - 1, "hankel": n + m - 1,
            "unstructured": m * n}[kind]


def _hd_ops(n: int, use_hd: bool) -> float:
    return n * math.log2(n) if use_hd else 0.0


def spinner(kind: str, gsz: int, bsz: int, n: int, m: int, itemsize: int,
            gen: int, width: int, use_hd: bool = True) -> Tuple[float, float]:
    """f(A·D1·H·D0·x) of G groups of B rows: x, each group's ``gen``
    generator values and two diagonals read once, the (B, width) output
    written once. Per row, the fast structured matvec
    (``structured.flops_fast``) plus the HD butterfly's n*log2(n) adds
    (none without HD, nor the diagonals)."""
    hd = 2 * n if use_hd else 0
    byts = itemsize * gsz * (bsz * n + gen + hd + bsz * width)
    ops = gsz * bsz * (structured.flops_fast(kind, m, n) + _hd_ops(n, use_hd))
    return ops, byts


def seeded(kind: str, gsz: int, bsz: int, n: int, m: int, itemsize: int,
           width: int, use_hd: bool = True) -> Tuple[float, float]:
    """The seeded spinner: x read once, the output written once, and each
    group's 8-byte seed (the port's int64 word). Operations: the
    spinner's, plus drawing each group's generator (``gen_elems``) and
    its 2n signs once."""
    byts = itemsize * gsz * bsz * (n + width) + 8 * gsz
    ops = gsz * bsz * (structured.flops_fast(kind, m, n) + _hd_ops(n, use_hd))
    ops += gsz * (gen_elems(kind, n, m) * OPS_PER_NORMAL
                  + (2 * n * OPS_PER_SIGN if use_hd else 0))
    return ops, byts


def srf_decode(b: int, h: int, m: int, dv: int, itemsize: int = 4
               ) -> Tuple[float, float]:
    """The SRF state update and readout: s and z read and written, phi_q,
    phi_k and v read, out written; 2 operations a multiply-add of the
    update and of the readout."""
    byts = itemsize * (2 * b * h * m * dv + 2 * b * h * m + 2 * b * h * m
                       + 2 * b * h * dv)
    return 4.0 * b * h * m * dv + 4.0 * b * h * m, byts


def gather(rows: int, d: int, itemsize: int) -> Tuple[float, float]:
    """A page gather of ``rows`` rows of d: read and written once."""
    return 0.0, 2 * rows * d * itemsize


def gather_dequant(rows: int, d: int, out_itemsize: int, pools: int = 1
                   ) -> Tuple[float, float]:
    """The int8 gather of ``pools`` pools (a layer's K and V: 2): int8
    rows and f32 scales read once, the dequantized rows written once;
    one multiply an element."""
    return (float(pools * rows * d),
            pools * (rows * d + 4 * rows + out_itemsize * rows * d))


def fwht(rows: int, n: int, itemsize: int) -> Tuple[float, float]:
    """The Walsh-Hadamard transform: n*log2(n) butterflies and a scale an
    element; read and written once."""
    return rows * n * math.log2(n) + rows * n, 2 * itemsize * rows * n


def circulant(rows: int, n: int, nb: int, m: int, itemsize: int,
              width: int) -> Tuple[float, float]:
    """The block-circulant projection: x and the generators read once,
    the (rows, width) output written once; the FFT product a row."""
    return (rows * structured.flops_fast("circulant", m, n),
            itemsize * (rows * n + nb * n + rows * width))
