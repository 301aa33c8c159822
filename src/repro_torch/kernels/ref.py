"""Plain PyTorch versions of the CUDA kernels in this package.

Each ``*_ref`` is the semantic ground truth: the CPU route of
``kernels.ops`` runs it, the CPU tests hold it to ``repro.kernels.ref``,
and ``chip_smoke.py`` holds each CUDA kernel to it on the card. The
serving path never calls these when its tensors lie on the card.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from repro_torch.core import structured, transforms


def fwht_ref(x: torch.Tensor, normalized: bool = True) -> torch.Tensor:
    """(B, n) -> (B, n) Walsh-Hadamard transform (Sylvester order), in f32
    with one cast to x's dtype on the way out: the CUDA kernel's (and the
    TPU kernel's) numerics. The reference's jnp oracle rounds bf16 input
    at every butterfly stage instead."""
    return transforms.fwht(x.float(), normalized=normalized).to(x.dtype)


CIRCULANT_EPILOGUES = ("identity", "relu", "heaviside", "exp", "cos_sin")


def circulant_matrix(g: torch.Tensor, m: int) -> torch.Tensor:
    """Dense (m, n) block-circulant A of generators g (nb, n):
    A[i, j] = g[i // n, (j - i mod n) mod n]."""
    nb, n = g.shape
    i = torch.arange(nb * n, device=g.device)
    j = torch.arange(n, device=g.device)
    return g[(i // n)[:, None], (j[None, :] - (i % n)[:, None]) % n][:m]


def circulant_project_ref(g: torch.Tensor, x: torch.Tensor, m: int,
                          epilogue: str = "identity",
                          sq: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Block-circulant projection with a fused feature epilogue.

    g: (nb, n) block generators; x: (B, n); out: (B, m) —
    y[B, i] = sum_j x[B, j] g[b(i), (j - i') mod n],  i = b(i)*n + i'.
    epilogues: identity | relu | heaviside | exp (exp(y - sq[B])) |
    cos_sin (out dim 2m: [cos(y), sin(y)]). f32 math, one cast to x's
    dtype on the way out (the reference's jnp oracle rounds bf16 after
    the product).
    """
    y = x.float() @ circulant_matrix(g.float(), m).T
    if epilogue == "identity":
        out = y
    elif epilogue == "relu":
        out = torch.relu(y)
    elif epilogue == "heaviside":
        out = (y >= 0).float()
    elif epilogue == "exp":
        if sq is None:
            raise ValueError("circulant_project: exp needs sq")
        out = torch.exp(y - sq.float()[:, None])
    elif epilogue == "cos_sin":
        out = torch.cat([torch.cos(y), torch.sin(y)], dim=-1)
    else:
        raise ValueError(epilogue)
    return out.to(x.dtype)


def _spinner_epilogue(y: torch.Tensor, x: torch.Tensor, epilogue: str,
                      out_scale: float) -> torch.Tensor:
    """Pointwise f of the spinner; ``x`` is the pre-HD input (for ``exp``
    the subtrahend 0.5||x||^2 equals 0.5||v||^2 by the HD isometry)."""
    if epilogue == "identity":
        r = y
    elif epilogue == "relu":
        r = torch.relu(y)
    elif epilogue == "heaviside":
        r = (y >= 0).to(y.dtype)
    elif epilogue == "sign":
        r = torch.sign(y)
    elif epilogue == "exp":
        xf = x.float()
        sq = 0.5 * torch.sum(xf * xf, dim=-1, keepdim=True)
        r = torch.exp(y.float() - sq).to(y.dtype)
    elif epilogue == "cos_sin":
        r = torch.cat([torch.cos(y), torch.sin(y)], dim=-1)
    else:
        raise ValueError(epilogue)
    return r if out_scale == 1.0 else r * out_scale


def _skew_matvec_diag(w: torch.Tensor, d1: Optional[torch.Tensor],
                      g: torch.Tensor, m: int) -> torch.Tensor:
    """Block skew-circulant matvec of (d1 ⊙ w) with the D1 diagonal folded
    into the complex skew modulation. w: (..., n); g: (nb, n) -> (..., m)."""
    n = w.shape[-1]
    d = structured._skew_modulation(n, w.device)
    dd = d if d1 is None else d * structured._f32(d1).to(torch.complex64)
    fx = torch.fft.fft(structured._f32(w).to(torch.complex64) * dd, n=n)
    fg = torch.fft.fft(structured._f32(g).to(torch.complex64) * d, n=n)
    y = torch.fft.ifft(fx[..., None, :] * torch.conj(fg), n=n) * torch.conj(d)
    y = y.real.to(w.dtype)                                    # (..., nb, n)
    return y.reshape(*w.shape[:-1], -1)[..., :m]


def _hd_kron(x: torch.Tensor, d0: torch.Tensor,
             d1: Optional[torch.Tensor]) -> torch.Tensor:
    """D1 · H · D0 · x with the Kronecker-form FWHT and 1/sqrt(n) folded
    into the left Hadamard factor. d1=None skips the output diagonal."""
    n = x.shape[-1]
    a, b = transforms.kron_factors(n)
    ha = transforms.hadamard(a, x.dtype, normalized=False,
                             device=x.device) * (1.0 / math.sqrt(n))
    hb = transforms.hadamard(b, x.dtype, normalized=False, device=x.device)
    xm = (d0 * x).reshape(*x.shape[:-1], a, b)
    y = torch.einsum("pa,...ab,bq->...pq", ha, xm, hb)
    y = y.reshape(*x.shape[:-1], n)
    return y if d1 is None else d1 * y


def _spinner_one(kind: str, m: int, epilogue: str, y_scale: float,
                 out_scale: float, g, h, d0, d1, x):
    params = {"g": g} if h is None else {"g": g, "h": h}
    if kind == "skew_circulant":
        w = x if d0 is None else _hd_kron(x, d0, None)
        y = _skew_matvec_diag(w, None if d0 is None else d1, g, m)
    else:
        v = x if d0 is None else _hd_kron(x, d0, d1)
        y = structured.matvec(kind, params, v, m)
    if y_scale != 1.0:
        y = y * y_scale
    return _spinner_epilogue(y, x, epilogue, out_scale)


def spinner_project_ref(kind: str, g: torch.Tensor, x: torch.Tensor, m: int,
                        d0: Optional[torch.Tensor] = None,
                        d1: Optional[torch.Tensor] = None,
                        h: Optional[torch.Tensor] = None,
                        epilogue: str = "identity",
                        y_scale: float = 1.0,
                        out_scale: float = 1.0) -> torch.Tensor:
    """Fused spinner  f(y_scale · A · D1 H D0 · x) · out_scale.

    x: (G, B, n); g (and the optional ldr ``h``) carry a leading group
    axis G; d0/d1: (G, n) or None (no HD). Output (G, B, m), or
    (G, B, 2m) = [cos | sin] for cos_sin. Kronecker-form FWHT and the
    FFT structured matvec, one group at a time.

    All arithmetic is f32 with one cast to x's dtype on the way out —
    the CUDA kernel's (and the TPU kernel's) numerics. For f32 inputs
    this is exactly ``repro.kernels.ref.spinner_project_ref``; for bf16
    the reference instead rounds the projection to bf16 before the
    epilogue.
    """
    f32 = lambda t: None if t is None else t.float()      # noqa: E731
    outs = [_spinner_one(kind, m, epilogue, y_scale, out_scale,
                         f32(g[i]), f32(None if h is None else h[i]),
                         f32(None if d0 is None else d0[i]),
                         f32(None if d1 is None else d1[i]), x[i].float())
            for i in range(x.shape[0])]
    return torch.stack(outs).to(x.dtype)


def spinner_project_seeded_ref(kind: str, seeds: torch.Tensor,
                               x: torch.Tensor, m: int, *, r: int = 1,
                               ldr_nnz: int = 4, use_hd: bool = True,
                               epilogue: str = "identity",
                               y_scale: float = 1.0,
                               out_scale: float = 1.0) -> torch.Tensor:
    """Seeded spinner: rebuild the exact params the (G,) seeds encode
    (``seedgen.grouped_params``) and run :func:`spinner_project_ref` on
    them. The params exist only inside this call."""
    from . import seedgen
    params = seedgen.grouped_params(kind, x.shape[-1], m,
                                    seeds.reshape(-1).to(x.device), r=r,
                                    ldr_nnz=ldr_nnz, use_hd=use_hd)
    return spinner_project_ref(kind, params["g"], x, m, d0=params.get("d0"),
                               d1=params.get("d1"), h=params.get("h"),
                               epilogue=epilogue, y_scale=y_scale,
                               out_scale=out_scale)


def srf_decode_ref(s: torch.Tensor, z: torch.Tensor, phi_q: torch.Tensor,
                   phi_k: torch.Tensor, v: torch.Tensor, eps: float = 1e-6
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Fused SRF decode-step state update + readout (functional).

    s: (B, H, m, dv)  z: (B, H, m)  phi_q/phi_k: (B, H, m)  v: (B, H, dv)
    returns (s', z', out) with out: (B, H, dv).
    """
    s2 = s + phi_k[..., :, None] * v[..., None, :]
    z2 = z + phi_k
    num = torch.einsum("bhm,bhmd->bhd", phi_q, s2)
    den = torch.einsum("bhm,bhm->bh", phi_q, z2)
    return s2, z2, num / (den[..., None] + eps)


def paged_gather_ref(pool: torch.Tensor, tables: torch.Tensor
                     ) -> torch.Tensor:
    """Gather cache pages into per-request contiguous views.

    pool: (N, P, D) pooled pages; tables: (R, M) integer page ids
    -> (R, M*P, D). Out-of-range ids clamp to [0, N-1] (the kernel's
    rule; callers mask what they read there)."""
    n, p, d = pool.shape
    r, m = tables.shape
    idx = tables.long().clamp(0, n - 1)
    return pool[idx].reshape(r, m * p, d)


def paged_gather_dequant_ref(pool: torch.Tensor, scales: torch.Tensor,
                             tables: torch.Tensor,
                             out_dtype=torch.float32) -> torch.Tensor:
    """The fused int8 gather + dequant: pool (N, P, D) int8, scales
    (N, P, 1) float32 row scales, tables (R, M) -> (R, M*P, D)
    ``out_dtype``, computed as ``(float(q) * scale).to(out_dtype)``."""
    n, p, d = pool.shape
    r, m = tables.shape
    idx = tables.long().clamp(0, n - 1)
    out = pool[idx].float() * scales[idx]
    return out.to(out_dtype).reshape(r, m * p, d)
