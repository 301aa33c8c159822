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


def apply_m_rope(x: torch.Tensor, positions3: torch.Tensor, theta: float,
                 sections) -> torch.Tensor:
    """Qwen2-VL multimodal RoPE. x: (B, H, L, hd); positions3: (3, B, L)
    = (t, h, w) ids. The hd/2 frequency slots are split into
    ``sections`` (sum = hd/2), each rotated by the position row of its
    axis; half-split convention, as ``apply_rope``."""
    hd = x.shape[-1]
    if sum(sections) != hd // 2:
        raise ValueError(f"M-RoPE sections {tuple(sections)} do not sum to "
                         f"head_dim / 2 = {hd // 2}")
    inv = rope_freqs(hd, theta, x.device)
    sec_id = torch.repeat_interleave(
        torch.arange(len(sections), device=x.device),
        torch.as_tensor(tuple(sections), device=x.device))
    pos = positions3.to(x.device)[sec_id]                  # (hd/2, B, L)
    ang = pos.permute(1, 2, 0).float() * inv               # (B, L, hd/2)
    cos, sin = torch.cos(ang)[:, None], torch.sin(ang)[:, None]
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


def unembed(p_head: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """(B, L, d) @ (d, V) in f32 for a stable softmax-xent."""
    return x.float() @ p_head.float()


# rows of logits whose f32 temporaries exist at once inside cross_entropy
# (about 64 MiB of f32 at a vocabulary of 150k)
XENT_ROWS = 128


class _CrossEntropy(torch.autograd.Function):
    """Mean xent of (R, V) logits over valid rows, with the f32 upcast
    inside the reductions, a chunk of ``XENT_ROWS`` rows at a time: no
    (R, V) f32 copy of bf16 logits is made, in the forward or in the
    backward. As in the reference: the row max m is taken without
    gradient (``stop_gradient``), exp runs in f32 on ``logits - m``
    rounded to the logits' dtype, and the gradient (softmax minus
    one-hot) reaches the logits in their dtype."""

    @staticmethod
    def forward(ctx, logits, safe, mask):
        rows = logits.shape[0]
        m = torch.empty((rows, 1), dtype=logits.dtype, device=logits.device)
        z = torch.empty(rows, dtype=torch.float32, device=logits.device)
        for i in range(0, rows, XENT_ROWS):
            lg = logits[i:i + XENT_ROWS]
            m[i:i + XENT_ROWS] = torch.amax(lg, dim=-1, keepdim=True)
            z[i:i + XENT_ROWS] = torch.sum(
                torch.exp((lg - m[i:i + XENT_ROWS]).float()), dim=-1)
        logz = torch.log(z) + m[:, 0].float()
        gold = torch.gather(logits, -1, safe[:, None])[:, 0]
        count = torch.clamp(mask.sum(), min=1)
        nll = (logz - gold.float()) * mask
        ctx.save_for_backward(logits, safe, mask, m, z, count)
        return nll.sum() / count

    @staticmethod
    def backward(ctx, dloss):
        logits, safe, mask, m, z, count = ctx.saved_tensors
        w = (dloss * mask / count)[:, None]                  # (R, 1) f32
        grad = torch.empty_like(logits)
        cols = torch.arange(logits.shape[1], device=logits.device)
        for i in range(0, logits.shape[0], XENT_ROWS):
            sl = slice(i, i + XENT_ROWS)
            p = torch.exp((logits[sl] - m[sl]).float()) / z[sl, None]
            gold = (cols[None, :] == safe[sl, None]) * w[sl]
            grad[sl] = (p * w[sl]).to(logits.dtype) - gold.to(logits.dtype)
        return grad, None, None


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  vocab: int) -> torch.Tensor:
    """Mean xent over valid labels; labels >= vocab or < 0 are masked
    (covers the vocab-padding tokens). logits (..., V), labels (...)."""
    mask = (labels >= 0) & (labels < vocab)
    safe = torch.where(mask, labels, 0).long()
    v = logits.shape[-1]
    return _CrossEntropy.apply(logits.reshape(-1, v), safe.reshape(-1),
                               mask.reshape(-1).float())
