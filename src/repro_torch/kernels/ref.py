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
