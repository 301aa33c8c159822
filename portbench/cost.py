"""The yardstick's arithmetic, frozen here so that the program's own
copy may move: the card's peaks, what each custom kernel's function
needs (a copy of ``repro_torch/kernels/cost.py`` with
``core/structured.flops_fast``), and the operations a model's useful
work needs, counted from the configuration and the valid tokens.

Kernel costs are ``(operations, bytes)``: bytes count each input read
once and each output written once, whatever the kernel reads again;
operations are the function's own, not what the kernel does."""
from __future__ import annotations

import math
from typing import Dict, Tuple

# NVIDIA H100 SXM data sheet, dense, at its 700 W limit
PEAK_BF16_FLOPS = 989e12
PEAK_F32_FLOPS = 67e12
PEAK_BYTES_S = 3.35e12


def bound_s(ops: float, byts: float) -> float:
    """The least time the card could take: the larger of operations over
    the float32 peak and bytes over the HBM rate (as the port's
    ``chip_smoke.bound``)."""
    return max(ops / PEAK_F32_FLOPS, byts / PEAK_BYTES_S)


# -- kernels (a copy of repro_torch/kernels/cost.py) --------------------------

def flops_fast(kind: str, m: int, n: int, r: int = 1) -> float:
    """~FLOPs of the fast structured matvec (per input vector)."""
    if kind == "unstructured":
        return 2.0 * m * n
    if kind in ("circulant", "skew_circulant"):
        return 5.0 * n * math.log2(max(n, 2)) * 3
    if kind in ("toeplitz", "hankel"):
        p = n + m
        return 5.0 * p * math.log2(max(p, 2)) * 3
    if kind == "ldr":
        return r * 2 * 5.0 * n * math.log2(max(n, 2)) * 3
    raise ValueError(kind)


def gen_elems(kind: str, n: int, m: int) -> int:
    return {"circulant": -(-m // n) * n, "skew_circulant": -(-m // n) * n,
            "toeplitz": n + m - 1, "hankel": n + m - 1,
            "unstructured": m * n}[kind]


def spinner(kind: str, gsz: int, bsz: int, n: int, m: int, itemsize: int,
            gen: int, width: int, use_hd: bool = True) -> Tuple[float, float]:
    """f(A·D1·H·D0·x) of G groups of B rows."""
    hd = 2 * n if use_hd else 0
    byts = itemsize * gsz * (bsz * n + gen + hd + bsz * width)
    ops = gsz * bsz * (flops_fast(kind, m, n)
                       + (n * math.log2(n) if use_hd else 0.0))
    return ops, byts


def gather(rows: int, d: int, itemsize: int, read_rows: int = -1
           ) -> Tuple[float, float]:
    """A page gather of ``rows`` rows of d: read and written once.
    ``read_rows``: the rows of the distinct pages the tables name, where
    they repeat a page (the null page of padded columns is read once)."""
    reads = rows if read_rows < 0 else read_rows
    return 0.0, (rows + reads) * d * itemsize


# -- useful work of a model ---------------------------------------------------

def layer_matmul_params(s: Dict) -> int:
    """Weights a token multiplies by in one decoder layer."""
    d, hq, hkv, hd, ff = (s[k] for k in ("d", "hq", "hkv", "hd", "ff"))
    return d * hq * hd + 2 * d * hkv * hd + hq * hd * d + 3 * d * ff


def token_flops(s: Dict, pos: int) -> float:
    """Forward FLOPs of one valid token at position ``pos`` (0-based),
    the head left out: 2 a weight, and causal attention over positions
    0..pos (full: q.k and p.v; SRF: the feature maps by the structured
    formula, and the state's update and readout, which stand for all
    earlier positions)."""
    layers, hq, hkv, hd = s["layers"], s["hq"], s["hkv"], s["hd"]
    f = 2.0 * layer_matmul_params(s)
    if s["attn"] == "srf":
        m = s["m"]
        feat = (hq + hkv) * (flops_fast(s["kind"], m, hd)
                             + hd * math.log2(hd))
        f += feat + hq * (4.0 * m * hd + 4.0 * m)
    else:
        f += 4.0 * hq * hd * (pos + 1)
    return layers * f


def tokens_flops(s: Dict, start: int, end: int) -> float:
    """``token_flops`` summed over the positions start..end-1 (it is
    affine in the position)."""
    n = end - start
    f0 = token_flops(s, 0)
    return n * f0 + (token_flops(s, 1) - f0) * (start + end - 1) * n / 2


def head_flops(s: Dict) -> float:
    return 2.0 * s["d"] * s["vocab"]
