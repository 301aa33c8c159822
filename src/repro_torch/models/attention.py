"""GQA attention with the paper's SRF state for the paged serving engine.

Port of the SRF paged path of ``repro.models.attention``: ``srf_cfg``,
``attn_init`` and ``attention`` in mode ``"paged"`` with
``attn_impl="srf"``, whose per-request state is one constant-size page
{"s": (Hq, m, dv), "z": (Hq, m)} at the request's slot. Decode (C == 1)
runs the fused CUDA srf_decode kernel; chunked prefill (C > 1) is plain
einsum math, as in the reference.

Not ported in this slice (they raise NotImplementedError): the full-KV
paged path, MLA, cross attention and the train / prefill / decode modes
of the non-paged cache.

Unlike the reference, which returns new pools, the paged path writes the
updated state rows into the pool IN PLACE (the pool is the engine's
preallocated buffer; nothing else holds a view of those rows).
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.core import srf_attention as srf
from repro_torch.core.srf_attention import SRFConfig
from repro_torch.core.transforms import is_pow2
from repro_torch.kernels import ops as kops

from . import layers

NOT_IN_SLICE = ("not ported yet: the PyTorch port serves the dense SRF "
                "family only (ROADMAP.md, 'Port state')")


def srf_cfg(cfg) -> SRFConfig:
    if cfg.is_mla:
        raise NotImplementedError(f"MLA attention is {NOT_IN_SLICE}")
    dim = cfg.head_dim
    return SRFConfig(kind=cfg.srf.kind, n_features=cfg.srf.n_features,
                     head_dim=dim, feature=cfg.srf.feature, r=cfg.srf.r,
                     use_hd=is_pow2(dim), chunk=cfg.srf.chunk,
                     seeded=cfg.srf.seeded)


def attn_init(gen: torch.Generator, cfg, dtype, device=None,
              lead=()) -> Dict:
    """Attention params; ``lead`` stacks a leading layer axis."""
    if cfg.is_mla:
        raise NotImplementedError(f"MLA attention is {NOT_IN_SLICE}")
    d = cfg.d_model
    p: Dict = {
        "wq": layers.dense_init(gen, d, cfg.q_dim, dtype, device, lead=lead),
        "wk": layers.dense_init(gen, d, cfg.kv_dim, dtype, device, lead=lead),
        "wv": layers.dense_init(gen, d, cfg.kv_dim, dtype, device, lead=lead),
        "wo": layers.dense_init(gen, cfg.q_dim, d, dtype, device, lead=lead)}
    if cfg.qkv_bias:
        for name, dim in (("bq", cfg.q_dim), ("bk", cfg.kv_dim),
                          ("bv", cfg.kv_dim)):
            p[name] = torch.zeros((*lead, dim), dtype=dtype, device=device)
    if cfg.qk_norm:
        p["q_norm"] = torch.ones((*lead, cfg.head_dim), dtype=dtype,
                                 device=device)
        p["k_norm"] = torch.ones((*lead, cfg.head_dim), dtype=dtype,
                                 device=device)
    if cfg.attn_impl == "srf":
        sc = srf_cfg(cfg)
        per_layer = [srf.init(gen, sc, cfg.n_kv_heads, dtype, device)
                     for _ in range(lead[0] if lead else 1)]
        if lead:
            p["srf"] = tuple({k: torch.stack([pl[i][k] for pl in per_layer])
                              for k in per_layer[0][i]}
                             for i in range(len(per_layer[0])))
        else:
            p["srf"] = per_layer[0]
    return p


def _split_heads(x: torch.Tensor, n_heads: int, hd: int) -> torch.Tensor:
    b, l, _ = x.shape
    return x.reshape(b, l, n_heads, hd).transpose(1, 2)


def _merge_heads(x: torch.Tensor) -> torch.Tensor:
    b, h, l, hd = x.shape
    return x.transpose(1, 2).reshape(b, l, h * hd)


def _repeat_kv(x: torch.Tensor, g: int) -> torch.Tensor:
    """(B, Hkv, ...) -> (B, Hkv*g, ...)."""
    return torch.repeat_interleave(x, g, dim=1)


def _paged_srf(pool: Dict[str, torch.Tensor], slots: torch.Tensor,
               phi_q: torch.Tensor, phi_k: torch.Tensor, v: torch.Tensor,
               q_valid: torch.Tensor) -> torch.Tensor:
    """SRF paged path: the state is one constant-size page per request at
    its slot of the slot-domain pool (``serving.paged_cache``).

    Chunked prefill runs C tokens causally against the carried state;
    decode (C=1) runs the fused srf_decode kernel on an f32 copy of the
    gathered state rows. Invalid chunk rows have phi_k/v zeroed, which
    makes their state contribution an exact no-op. Padded batch rows
    carry slot 0, the null slot: they write it (several times) and nobody
    reads it as live state. The updated rows are scattered back into the
    pool in place, cast to the pool's dtype."""
    b, h, c, m = phi_q.shape
    s = pool["s"][slots]                               # (B, Hq, m, dv) copy
    z = pool["z"][slots]
    valid = q_valid[:, None, :, None].to(phi_k.dtype)
    phi_k = phi_k * valid
    v = v * valid
    if c == 1:
        s2, z2, out = kops.srf_decode(s.float(), z.float(),
                                      phi_q[:, :, 0].float().contiguous(),
                                      phi_k[:, :, 0].float().contiguous(),
                                      v[:, :, 0].float().contiguous())
        out = out[:, :, None, :]
    else:
        tri = torch.tril(torch.ones((c, c), dtype=phi_q.dtype,
                                    device=phi_q.device))
        attn = torch.einsum("bhim,bhjm->bhij", phi_q, phi_k) * tri
        num = torch.einsum("bhij,bhjd->bhid", attn, v) \
            + torch.einsum("bhim,bhmd->bhid", phi_q, s.to(phi_q.dtype))
        den = torch.einsum("bhij->bhi", attn) \
            + torch.einsum("bhim,bhm->bhi", phi_q, z.to(phi_q.dtype))
        out = num / (den[..., None] + 1e-6)
        s2 = s + torch.einsum("bhjm,bhjd->bhmd", phi_k, v).to(s.dtype)
        z2 = z + torch.sum(phi_k, dim=-2).to(z.dtype)
    pool["s"][slots] = s2.to(pool["s"].dtype)
    pool["z"][slots] = z2.to(pool["z"].dtype)
    return out.to(phi_q.dtype)


def attention(p, cfg, x: torch.Tensor, positions: torch.Tensor, mode: str,
              cache: Dict) -> torch.Tensor:
    """Paged GQA attention with SRF state: (B, C, d) -> (B, C, d); the
    slot pool in ``cache["pool"]`` is updated in place."""
    if mode != "paged":
        raise NotImplementedError(f"attention mode {mode!r} is "
                                  f"{NOT_IN_SLICE}")
    if cfg.is_mla:
        raise NotImplementedError(f"MLA attention is {NOT_IN_SLICE}")
    if cfg.attn_impl != "srf":
        raise NotImplementedError(f"full-KV paged attention is "
                                  f"{NOT_IN_SLICE}")
    if cfg.m_rope:
        raise NotImplementedError(f"M-RoPE is {NOT_IN_SLICE}")
    q = x @ p["wq"]
    k = x @ p["wk"]
    v = x @ p["wv"]
    if cfg.qkv_bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    q = _split_heads(q, cfg.n_heads, cfg.head_dim)
    k = _split_heads(k, cfg.n_kv_heads, cfg.head_dim)
    v = _split_heads(v, cfg.n_kv_heads, cfg.head_dim)
    if cfg.qk_norm:
        q = layers.head_rmsnorm(p["q_norm"], q, cfg.norm_eps)
        k = layers.head_rmsnorm(p["k_norm"], k, cfg.norm_eps)
    q = layers.apply_rope(q, positions, cfg.rope_theta)
    k = layers.apply_rope(k, positions, cfg.rope_theta)

    sc = srf_cfg(cfg)
    g = cfg.n_heads // cfg.n_kv_heads
    b, hq, l, hd = q.shape
    qg = q.reshape(b, cfg.n_kv_heads, g * l, hd)
    phi_q = srf.feature_map(sc, p["srf"], qg, is_query=True)
    phi_q = phi_q.reshape(b, hq, l, -1)
    phi_k = _repeat_kv(srf.feature_map(sc, p["srf"], k, is_query=False), g)
    out = _paged_srf(cache["pool"], cache["slots"], phi_q, phi_k,
                     _repeat_kv(v, g), cache["q_valid"])
    return _merge_heads(out) @ p["wo"]
