"""Structured random-feature (SRF) attention: the paper's embedding as an
attention layer. Port of ``repro.core.srf_attention``.

softmax(q k^T / sqrt(d)) V is approximated by linear attention over the
paper's nonlinear embedding:  phi(q) [phi(k)^T V] / phi(q) [phi(k)^T 1]
with phi(x) = f(A D1 H D0 x)/sqrt(m) and A a structured matrix. The
decode state is O(m d) per head, independent of sequence length.

Shapes: q,k: (B, H, L, d)   v: (B, H, L, dv)   phi: (B, H, L, m).
GQA is handled by the caller (q-heads grouped onto kv-heads first).
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Tuple

import torch

from . import features, spinner


@dataclass(frozen=True)
class SRFConfig:
    kind: str = "circulant"     # structured class for the projection
    n_features: int = 256       # m
    head_dim: int = 128         # n (power of two -> HD preconditioner)
    feature: str = "softmax_pos"  # softmax_pos | relu | trig
    use_hd: bool = True
    r: int = 1                  # displacement rank for ldr
    chunk: int = 128            # causal chunk length
    depth: int = 1              # spinner blocks
    seeded: bool = False        # zero-storage projections (params are one
                                # seed per head per block)

    @property
    def pipeline(self) -> spinner.SpinnerPipeline:
        """The per-head embedding as a SpinnerPipeline (depth blocks)."""
        return spinner.hd_chain(self.kind, n=self.head_dim,
                                m=self.n_features, depth=self.depth,
                                r=self.r, use_hd=self.use_hd,
                                seeded=self.seeded)

    @property
    def feat_dim(self) -> int:
        return 2 * self.n_features if self.feature == "trig" \
            else self.n_features


def init(gen: torch.Generator, cfg: SRFConfig, n_kv_heads: int,
         dtype=torch.float32, device=None
         ) -> Tuple[Dict[str, torch.Tensor], ...]:
    """Per-kv-head independent pipelines: a tuple of per-block param
    dicts, every leaf with a leading head axis, on ``device`` (by default
    the generator's own device)."""
    device = gen.device if device is None else device
    pipe = cfg.pipeline
    heads = [pipe.init(gen, dtype, device) for _ in range(n_kv_heads)]
    return tuple({k: torch.stack([hp[i][k] for hp in heads])
                  for k in heads[0][i]} for i in range(pipe.depth))


def fold_embed(params, embed_seeds: torch.Tensor):
    """Personalize per-head seed params with per-request embed seeds.

    Each block's ``{"seed": (..., H)}`` becomes ``{"seed": (..., H*B)}``,
    (head, request)-major: seed 0 is the sentinel for the base projection
    (the head seed passes through unfolded), any other value derives an
    independent per-(head, request) seed through ``seedgen.fold_seed``.
    Leading axes (a stacked layer axis) are kept, so a caller can fold
    every layer's seeds at once (reference: ``_fold_embed``)."""
    from repro_torch.kernels import seedgen       # kernels import core
    e = seedgen.words(embed_seeds, params[0]["seed"].device)      # (B,)

    def fold_leaf(hs):                            # (..., H) -> (..., H*B)
        hs = hs[..., None]
        folded = seedgen.fold_seed(hs, e)
        return torch.where(e == 0, hs & seedgen.MASK,
                           folded).flatten(-2)

    return tuple({"seed": fold_leaf(p["seed"])} for p in params)


def feature_map(cfg: SRFConfig, params, x: torch.Tensor, is_query: bool,
                embed_seeds=None) -> torch.Tensor:
    """(B, H, L, d) -> (B, H, L, feat_dim). The softmax-kernel scaling
    d^-1/4 is folded in, so phi(q).phi(k) ~ exp(q.k/sqrt(d)) up to a
    global constant that cancels in the normalizer. All H per-head
    pipelines run as ONE grouped spinner call per block.

    ``embed_seeds``: optional (B,) per-request projection seeds (seeded
    mode only; 0 = base projection). Groups then become per-(head,
    request), G = H*B, each with its own folded seed: still one call per
    block."""
    if embed_seeds is not None:
        if not cfg.seeded:
            raise ValueError("embed_seeds requires SRFConfig.seeded=True")
        return feature_map_folded(cfg, fold_embed(params, embed_seeds), x,
                                  is_query)
    scale = cfg.head_dim ** -0.25
    b, h, l, d = x.shape
    xg = x.transpose(0, 1).reshape(h, b * l, d)          # head-major groups
    return _phi(cfg, params, xg, is_query, scale).reshape(
        h, b, l, -1).transpose(0, 1)


def feature_map_folded(cfg: SRFConfig, folded, x: torch.Tensor,
                       is_query: bool) -> torch.Tensor:
    """:func:`feature_map` with embed seeds already folded into the params
    (``fold_embed``, leaves (H*B,)): the serving step folds every layer's
    seeds once, then calls this per layer."""
    scale = cfg.head_dim ** -0.25
    b, h, l, d = x.shape
    xg = x.transpose(0, 1).reshape(h * b, l, d)          # (head, request)
    return _phi(cfg, folded, xg, is_query, scale).reshape(
        h, b, l, -1).transpose(0, 1)


def _phi(cfg: SRFConfig, params, xg: torch.Tensor, is_query: bool,
         scale: float) -> torch.Tensor:
    """The configured feature of grouped rows xg: (G, R, d) -> (G, R, F)."""
    pipe = cfg.pipeline
    if cfg.feature == "softmax_pos":
        phi = features.phi_softmax_pos(pipe, params, xg, scale=scale,
                                       stabilize=is_query, grouped=True)
    elif cfg.feature == "trig":
        phi = features.phi_trig(pipe, params, xg * scale, grouped=True)
    elif cfg.feature == "relu":
        inv = 1.0 / math.sqrt(cfg.n_features)
        phi = pipe.with_f("relu").apply(params, xg * scale, out_scale=inv,
                                        grouped=True) + 1e-6 * inv
    else:
        raise ValueError(cfg.feature)
    return phi


def attention_noncausal(phi_q: torch.Tensor, phi_k: torch.Tensor,
                        v: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """Encoder (bidirectional) SRF attention: every query attends to
    every key through the summed state phi_k^T v and its normalizer."""
    kv = torch.einsum("bhlm,bhld->bhmd", phi_k, v)
    z = torch.sum(phi_k, dim=-2)                         # (B, H, m)
    num = torch.einsum("bhlm,bhmd->bhld", phi_q, kv)
    den = torch.einsum("bhlm,bhm->bhl", phi_q, z)
    return num / (den[..., None] + eps)


def attention_causal(cfg: SRFConfig, phi_q: torch.Tensor,
                     phi_k: torch.Tensor, v: torch.Tensor,
                     eps: float = 1e-6) -> torch.Tensor:
    """Causal SRF attention via a chunked prefix-state loop (chunk C):
    O(L m (d + C)); the state carried between chunks is the O(m d)
    object."""
    b, h, l, m = phi_q.shape
    dv = v.shape[-1]
    c = min(cfg.chunk, l)
    if l % c:                  # zero-pad to a chunk multiple (zero phi_k rows
        pad = c - l % c        # are inert; padded outputs sliced off)
        phi_q, phi_k, v = (torch.nn.functional.pad(t, (0, 0, 0, pad))
                           for t in (phi_q, phi_k, v))
        return attention_causal(cfg, phi_q, phi_k, v, eps)[..., :l, :]
    tri = torch.tril(torch.ones((c, c), dtype=phi_q.dtype,
                                device=phi_q.device))
    s = torch.zeros((b, h, m, dv), dtype=phi_q.dtype, device=phi_q.device)
    z = torch.zeros((b, h, m), dtype=phi_q.dtype, device=phi_q.device)
    outs = []
    for i in range(0, l, c):
        q_c, k_c, v_c = (t[:, :, i:i + c] for t in (phi_q, phi_k, v))
        attn = torch.einsum("bhim,bhjm->bhij", q_c, k_c) * tri
        num = torch.einsum("bhij,bhjd->bhid", attn, v_c) \
            + torch.einsum("bhim,bhmd->bhid", q_c, s)
        den = torch.einsum("bhij->bhi", attn) \
            + torch.einsum("bhim,bhm->bhi", q_c, z)
        outs.append(num / (den[..., None] + eps))
        s = s + torch.einsum("bhjm,bhjd->bhmd", k_c, v_c)
        z = z + torch.sum(k_c, dim=-2)
    return torch.cat(outs, dim=2)


def prefill_state(phi_k: torch.Tensor, v: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Decode state from a processed prompt: S = phi_k^T v, z."""
    return (torch.einsum("bhlm,bhld->bhmd", phi_k, v),
            torch.sum(phi_k, dim=-2))


def decode_step(state: Tuple[torch.Tensor, torch.Tensor],
                phi_q: torch.Tensor, phi_k: torch.Tensor,
                v_new: torch.Tensor, eps: float = 1e-6
                ) -> Tuple[Tuple[torch.Tensor, torch.Tensor], torch.Tensor]:
    """One-token decode. phi_q/phi_k: (B,H,1,m), v_new: (B,H,1,dv).
    State update BEFORE readout (the new token attends to itself)."""
    s, z = state
    s = s + torch.einsum("bhlm,bhld->bhmd", phi_k, v_new)
    z = z + torch.sum(phi_k, dim=-2)
    num = torch.einsum("bhlm,bhmd->bhld", phi_q, s)
    den = torch.einsum("bhlm,bhm->bhl", phi_q, z)
    return (s, z), num / (den[..., None] + eps)


def reference_softmax(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      causal: bool = True) -> torch.Tensor:
    """Exact softmax attention (the oracle of the SRF quality tests)."""
    d = q.shape[-1]
    logits = torch.einsum("bhid,bhjd->bhij", q, k) / math.sqrt(d)
    if causal:
        l = q.shape[-2]
        mask = torch.tril(torch.ones((l, l), dtype=torch.bool,
                                     device=q.device))
        logits = torch.where(mask, logits, torch.full_like(logits, -1e30))
    w = torch.softmax(logits, dim=-1)
    return torch.einsum("bhij,bhjd->bhid", w, v)
