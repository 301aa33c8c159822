"""Shared layer primitives: RMSNorm, RoPE, SwiGLU MLP, embeddings.

Port of ``repro.models.layers``. Functional style: ``*_init`` returns
tensors or a params dict; the apply functions are pure. Weight layout
as in the reference: 2-D matrices are (in_dim, out_dim), head axes are
merged into out_dim.
"""
from __future__ import annotations

import math
from typing import Dict, Optional

import torch
import torch.nn.functional as F


def dense_init(gen: torch.Generator, in_dim: int, out_dim: int, dtype,
               device=None, scale: Optional[float] = None,
               lead=()) -> torch.Tensor:
    """N(0, 1/in_dim) weights; ``lead`` stacks that many independent
    matrices in front (the per-layer axis of a segment)."""
    s = scale if scale is not None else 1.0 / math.sqrt(in_dim)
    w = torch.randn((*lead, in_dim, out_dim), generator=gen, device=device)
    return (w * s).to(dtype)


def rmsnorm_init(dim: int, dtype, device=None, lead=()) -> Dict:
    return {"w": torch.ones((*lead, dim), dtype=dtype, device=device)}


def rmsnorm(p, x: torch.Tensor, eps: float) -> torch.Tensor:
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * p["w"].float()).to(x.dtype)


def head_rmsnorm(w: torch.Tensor, x: torch.Tensor, eps: float
                 ) -> torch.Tensor:
    """qk-norm: normalize the last (head_dim) axis of (..., H, L, hd)."""
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * w.float()).to(x.dtype)


def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    e = torch.arange(0, head_dim, 2, dtype=torch.float32,
                     device=device) / head_dim
    return 1.0 / (theta ** e)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float
               ) -> torch.Tensor:
    """x: (B, H, L, hd); positions: (B, L) int. Half-split convention."""
    hd = x.shape[-1]
    inv = rope_freqs(hd, theta, x.device)
    ang = positions[:, None, :, None].float() * inv      # (B, 1, L, hd/2)
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x.float().chunk(2, dim=-1)
    y = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return y.to(x.dtype)


def mlp_init(gen: torch.Generator, d: int, ff: int, dtype, device=None,
             lead=()) -> Dict:
    return {"wi": dense_init(gen, d, ff, dtype, device, lead=lead),
            "wg": dense_init(gen, d, ff, dtype, device, lead=lead),
            "wo": dense_init(gen, ff, d, dtype, device, lead=lead)}


def mlp(p, x: torch.Tensor) -> torch.Tensor:
    """SwiGLU."""
    return (F.silu(x @ p["wg"]) * (x @ p["wi"])) @ p["wo"]


def embed_init(gen: torch.Generator, vocab: int, d: int, dtype,
               device=None) -> Dict:
    w = torch.randn((vocab, d), generator=gen, device=device) * 0.02
    return {"tok": w.to(dtype)}


def embed(p, tokens: torch.Tensor) -> torch.Tensor:
    return p["tok"][tokens]
