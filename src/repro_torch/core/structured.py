"""Structured Gaussian matrices of the paper's P-model (Sec 2.2).

Every structured class is a budget of randomness ``g`` (t i.i.d. N(0,1)
values, t << m*n) plus an implicit sequence of matrices P_i with
``a^i = g . P_i`` as the i-th row of the projection.

Kinds (as in ``repro.core.structured``)
---------------------------------------
``unstructured``     t = m*n     the fully random baseline
``circulant``        t = n       rows are right-shifts of g           (eq. 7)
``skew_circulant``   t = n       wrap-around entries negated
``toeplitz``         t = n+m-1   constant diagonals                   (eq. 9)
``hankel``           t = n+m-1   constant anti-diagonals
``ldr``              t = r*n     sum_{i<=r} Z_1(g^i) Z_{-1}(h^i)      (eq. 11)

``matvec`` is the O(n log n) FFT path (``torch.fft``), ``materialize``
the dense O(mn) oracle. Both act on the LAST axis of ``x`` with any
leading batch axes. For m > n, circulant / skew_circulant / ldr are
block-stacked: ceil(m/n) independent blocks share one input.
"""
from __future__ import annotations

import math
from typing import Dict

import torch

KINDS = ("unstructured", "circulant", "skew_circulant", "toeplitz", "hankel",
         "ldr")


def n_blocks(kind: str, m: int, n: int) -> int:
    """Independent structured blocks stacked to reach m rows."""
    if kind in ("circulant", "skew_circulant", "ldr"):
        return -(-m // n)
    return 1


def budget(kind: str, m: int, n: int, r: int = 1) -> int:
    """Number t of i.i.d. Gaussians consumed ('budget of randomness')."""
    b = n_blocks(kind, m, n)
    if kind == "unstructured":
        return m * n
    if kind in ("circulant", "skew_circulant"):
        return b * n
    if kind in ("toeplitz", "hankel"):
        return n + m - 1
    if kind == "ldr":
        return b * r * n
    raise ValueError(f"unknown structured kind: {kind}")


def init(gen: torch.Generator, kind: str, m: int, n: int, r: int = 1,
         ldr_nnz: int = 4, dtype=torch.float32,
         device=None) -> Dict[str, torch.Tensor]:
    """Sample the generator parameters of one structured matrix from
    ``gen`` (shapes and laws as in the reference; the numbers differ,
    since torch and jax draw differently), on ``device`` — by default
    the generator's own device."""
    device = gen.device if device is None else device
    b = n_blocks(kind, m, n)

    def normal(*shape):
        return torch.randn(shape, generator=gen, device=device).to(dtype)

    if kind == "unstructured":
        return {"g": normal(m, n)}
    if kind in ("circulant", "skew_circulant"):
        return {"g": normal(b, n)}
    if kind in ("toeplitz", "hankel"):
        return {"g": normal(n + m - 1)}
    if kind == "ldr":
        g = normal(b, r, n)
        idx = torch.randint(0, n, (b, r, ldr_nnz), generator=gen,
                            device=device)
        sign = 2 * torch.randint(0, 2, (b, r, ldr_nnz), generator=gen,
                                 device=device) - 1
        val = (sign / math.sqrt(ldr_nnz * r)).to(dtype)
        h = torch.zeros((b, r, n), dtype=dtype, device=device)
        h.scatter_(-1, idx, val)
        return {"g": g, "h": h}
    raise ValueError(f"unknown structured kind: {kind}")


# ---------------------------------------------------------------------------
# dense materialization (oracle path)
# ---------------------------------------------------------------------------

def _ij(m: int, n: int, device):
    i = torch.arange(m, device=device)[:, None]
    j = torch.arange(n, device=device)[None, :]
    return i, j


def _circulant_dense(g: torch.Tensor, m: int) -> torch.Tensor:
    """A[i, j] = g[(j - i) mod n]."""
    n = g.shape[-1]
    i, j = _ij(m, n, g.device)
    return g[..., (j - i) % n]


def _skew_circulant_dense(g: torch.Tensor, m: int) -> torch.Tensor:
    """Like circulant but wrapped entries (j < i) are negated."""
    n = g.shape[-1]
    i, j = _ij(m, n, g.device)
    sign = torch.where(j - i < 0, -1.0, 1.0).to(g.dtype)
    return sign * g[..., (j - i) % n]


def _toeplitz_dense(g: torch.Tensor, m: int, n: int) -> torch.Tensor:
    """A[i, j] = gen(j - i): gen(d) = g[d] (d >= 0), g[n - 1 - d] (d < 0)."""
    i, j = _ij(m, n, g.device)
    d = j - i
    return g[torch.where(d >= 0, d, n - 1 - d)]


def _hankel_dense(g: torch.Tensor, m: int, n: int) -> torch.Tensor:
    """A[i, j] = g[i + j]."""
    i, j = _ij(m, n, g.device)
    return g[i + j]


def _ldr_dense(g: torch.Tensor, h: torch.Tensor, m: int, n: int
               ) -> torch.Tensor:
    """sum_i Z_1(g^i) Z_{-1}(h^i)  (eq. 11); Z_f(v)[i, j] =
    v[(i - j) mod n] * (f if i - j < 0 else 1)."""
    i, j = _ij(n, n, g.device)
    z1 = g[..., (i - j) % n]                                  # (r, n, n)
    sgn = torch.where(i - j < 0, -1.0, 1.0).to(h.dtype)
    zm1 = sgn * h[..., (i - j) % n]
    return torch.einsum("rik,rkj->ij", z1, zm1)[:m]


def materialize(kind: str, params: Dict[str, torch.Tensor], m: int, n: int
                ) -> torch.Tensor:
    """Dense (m, n) matrix A of the P-model — oracle for all fast paths."""
    g = params["g"]
    if kind == "unstructured":
        return g
    if kind == "circulant":
        return torch.stack([_circulant_dense(gb, n) for gb in g]
                           ).reshape(-1, n)[:m]
    if kind == "skew_circulant":
        return torch.stack([_skew_circulant_dense(gb, n) for gb in g]
                           ).reshape(-1, n)[:m]
    if kind == "toeplitz":
        return _toeplitz_dense(g, m, n)
    if kind == "hankel":
        return _hankel_dense(g, m, n)
    if kind == "ldr":
        return torch.stack([_ldr_dense(gb, hb, n, n)
                            for gb, hb in zip(g, params["h"])]
                           ).reshape(-1, n)[:m]
    raise ValueError(f"unknown structured kind: {kind}")


# ---------------------------------------------------------------------------
# fast FFT path (the paper's O(n log n) algorithm)
# ---------------------------------------------------------------------------

def _f32(x: torch.Tensor) -> torch.Tensor:
    """FFTs need f32; bf16/f16 inputs are upcast for the transform."""
    return x.float() if x.dtype in (torch.bfloat16, torch.float16) else x


def _circ_corr(x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """y[..., i] = sum_j x[..., j] g[(j - i) mod n] via real FFT; a
    leading block axis on g gives (..., nb, n)."""
    n = x.shape[-1]
    fx = torch.fft.rfft(_f32(x), n=n)
    fg = torch.fft.rfft(_f32(g), n=n)
    if g.dim() > 1:
        fx = fx.unsqueeze(-2)
    y = torch.fft.irfft(fx * torch.conj(fg), n=n)
    return y.to(x.dtype)


def _circ_conv(x: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """y[i] = sum_j v[(i - j) mod n] x[..., j]."""
    n = x.shape[-1]
    fx = torch.fft.rfft(_f32(x), n=n)
    fv = torch.fft.rfft(_f32(v), n=n)
    return torch.fft.irfft(fx * fv, n=n).to(x.dtype)


def _skew_modulation(n: int, device=None) -> torch.Tensor:
    """d[j] = exp(i pi j / n) (complex64): the diagonal similarity that
    turns a skew-circulant into a circulant."""
    ang = math.pi * torch.arange(n, dtype=torch.float32, device=device) / n
    return torch.polar(torch.ones_like(ang), ang)


def _skew_circ_matvec(x: torch.Tensor, g: torch.Tensor, m: int
                      ) -> torch.Tensor:
    """Rows of A[i,j] = sgn(j-i) g[(j-i) mod n], first m; a leading
    block axis on g gives (..., nb, n) before the cut."""
    n = x.shape[-1]
    d = _skew_modulation(n, x.device)
    fx = torch.fft.fft(_f32(x).to(torch.complex64) * d, n=n)
    fg = torch.fft.fft(_f32(g).to(torch.complex64) * d, n=n)
    if g.dim() > 1:
        fx = fx.unsqueeze(-2)
    y = torch.fft.ifft(fx * torch.conj(fg), n=n) * torch.conj(d)
    return y.real[..., :m].to(x.dtype)


def _toeplitz_matvec(x: torch.Tensor, g: torch.Tensor, m: int, n: int
                     ) -> torch.Tensor:
    """Toeplitz matvec by embedding into a circulant of size p = n + m."""
    p = n + m
    c = torch.zeros((p,), dtype=g.dtype, device=g.device)
    c[:n] = g[:n]                                  # diagonals d = 0..n-1
    if m > 1:
        k = torch.arange(1, m, device=g.device)
        c[p - k] = g[n - 1 + k]                    # d = -k -> g[n-1+k]
    xp = torch.nn.functional.pad(x, (0, p - n))
    return _circ_corr(xp, c)[..., :m]


def matvec(kind: str, params: Dict[str, torch.Tensor], x: torch.Tensor,
           m: int) -> torch.Tensor:
    """Fast structured matvec: (..., n) -> (..., m)."""
    g = params["g"]
    n = x.shape[-1]
    if kind == "unstructured":
        return torch.einsum("...n,mn->...m", x, g)
    if kind == "circulant":
        y = _circ_corr(x, g)                                  # (..., nb, n)
        return y.reshape(*x.shape[:-1], -1)[..., :m]
    if kind == "skew_circulant":
        y = _skew_circ_matvec(x, g, n)
        return y.reshape(*x.shape[:-1], -1)[..., :m]
    if kind == "toeplitz":
        return _toeplitz_matvec(x, g, m, n)
    if kind == "hankel":
        # A[i, j] = g[i + j] is a Toeplitz in the reversed input with
        # gen_T(d) = g[n - 1 - d]
        g2 = torch.cat([torch.flip(g[:n], (0,)), g[n:]])
        return _toeplitz_matvec(torch.flip(x, (-1,)), g2, m, n)
    if kind == "ldr":
        h = params["h"]
        d = _skew_modulation(n, x.device)
        fx = torch.fft.fft(_f32(x).to(torch.complex64) * d, n=n)
        blocks = []
        for gb, hb in zip(g, h):
            y = 0
            for gr, hr in zip(gb, hb):
                fh = torch.fft.fft(_f32(hr).to(torch.complex64) * d, n=n)
                u = (torch.fft.ifft(fx * fh, n=n) * torch.conj(d)
                     ).real.to(x.dtype)
                y = y + _circ_conv(u, gr)
            blocks.append(y)
        y = torch.stack(blocks, dim=-2)
        return y.reshape(*x.shape[:-1], -1)[..., :m]
    raise ValueError(f"unknown structured kind: {kind}")


def storage_floats(kind: str, m: int, n: int, r: int = 1) -> int:
    """Floats stored for the projection (paper's space-complexity claim)."""
    return budget(kind, m, n, r) + (r * n if kind == "ldr" else 0)


def flops_fast(kind: str, m: int, n: int, r: int = 1) -> float:
    """~FLOPs of the fast matvec path (per input vector)."""
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
