"""Hadamard transforms and the paper's Step-1 preprocessing  D1 H D0.

``H`` is the L2-normalized Sylvester-Hadamard matrix (n a power of two),
``D0``/``D1`` independent random +/-1 diagonals (paper Sec 2.3 Step 1).

Two FWHT realizations, as in ``repro.core.transforms``:
* ``fwht``       — log2(n)-stage butterfly along the last axis
* ``fwht_kron``  — 2-factor Kronecker form  H_n = H_a (x) H_b  computed as
                   two dense matmuls  H_a . mat(x) . H_b
Both give the same Sylvester ordering; the CUDA spinner kernel runs the
butterfly in shared memory.
"""
from __future__ import annotations

import math
from functools import lru_cache
from typing import Tuple

import numpy as np
import torch


def is_pow2(n: int) -> bool:
    return n > 0 and (n & (n - 1)) == 0


def next_pow2(n: int) -> int:
    return 1 << max(0, (n - 1).bit_length())


@lru_cache(maxsize=32)
def _hadamard_np(n: int) -> np.ndarray:
    """Unnormalized Sylvester Hadamard matrix as a cached numpy array."""
    if not is_pow2(n):
        raise ValueError(f"Hadamard order must be a power of two, got {n}")
    h = np.array([[1.0]], dtype=np.float32)
    while h.shape[0] < n:
        h = np.block([[h, h], [h, -h]])
    return h


def hadamard(n: int, dtype=torch.float32, normalized: bool = True,
             device=None) -> torch.Tensor:
    h = torch.as_tensor(_hadamard_np(n), dtype=dtype, device=device)
    return h / math.sqrt(n) if normalized else h


def fwht(x: torch.Tensor, normalized: bool = True) -> torch.Tensor:
    """Fast Walsh-Hadamard transform along the last axis (n = 2^k):
    the classic butterfly, log2(n) reshape/stack steps."""
    n = x.shape[-1]
    if not is_pow2(n):
        raise ValueError(f"fwht needs power-of-two length, got {n}")
    lead = x.shape[:-1]
    h = 1
    while h < n:
        x = x.reshape(*lead, n // (2 * h), 2, h)
        a = x[..., 0, :]
        b = x[..., 1, :]
        x = torch.stack([a + b, a - b], dim=-2)
        h *= 2
    x = x.reshape(*lead, n)
    if normalized:
        x = x * (1.0 / math.sqrt(n))
    return x


def kron_factors(n: int) -> Tuple[int, int]:
    """Balanced split n = a * b with both powers of two (a >= b)."""
    if not is_pow2(n):
        raise ValueError(f"kron_factors needs a power of two, got {n}")
    k = n.bit_length() - 1
    ka = (k + 1) // 2
    return 1 << ka, 1 << (k - ka)


def fwht_kron(x: torch.Tensor, normalized: bool = True) -> torch.Tensor:
    """Matmul-form FWHT:  H_n x = vec( H_a . mat(x) . H_b )  with n = a*b."""
    n = x.shape[-1]
    a, b = kron_factors(n)
    lead = x.shape[:-1]
    ha = hadamard(a, x.dtype, normalized=False, device=x.device)
    hb = hadamard(b, x.dtype, normalized=False, device=x.device)
    xm = x.reshape(*lead, a, b)
    y = torch.einsum("pa,...ab,bq->...pq", ha, xm, hb).reshape(*lead, n)
    if normalized:
        y = y * (1.0 / math.sqrt(n))
    return y


def sample_signs(gen: torch.Generator, n: int, dtype=torch.float32,
                 device=None) -> torch.Tensor:
    """n Rademacher (+/-1) signs drawn from ``gen``, on ``device`` (by
    default the generator's own device)."""
    device = gen.device if device is None else device
    bits = torch.randint(0, 2, (n,), generator=gen, device=device)
    return (2 * bits - 1).to(dtype)


def hd_preprocess(x: torch.Tensor, d0: torch.Tensor, d1: torch.Tensor,
                  use_kron: bool = False) -> torch.Tensor:
    """Paper Step 1:  x -> D1 . H . D0 . x  (normalized H; isometry)."""
    f = fwht_kron if use_kron else fwht
    return d1 * f(d0 * x)


def pad_pow2(x: torch.Tensor) -> torch.Tensor:
    """Zero-pad the last axis to the next power of two (for HD preproc)."""
    n = x.shape[-1]
    p = next_pow2(n)
    if p == n:
        return x
    return torch.nn.functional.pad(x, (0, p - n))
