"""GQA attention: the paged serving engine's step (full-KV pages or the
paper's SRF state) and the training forward.

Port of ``repro.models.attention``: ``srf_cfg``, ``attn_init`` and
``attention`` in modes ``"paged"`` and ``"train"``.

* ``attn_impl="full"`` (the configs' default): the chunk's k/v rows are
  scattered into the request's KV pages (bf16/f32, or int8 with one f32
  scale per token), then the whole table width is gathered back through
  the paged_gather / paged_gather_dequant CUDA kernels and attended with
  an f32 softmax (``_paged_full``). In training, causal softmax
  attention (``_softmax_attn``, query-chunked as the reference chunks
  it; plain PyTorch ops, as the reference's is plain jnp).
* ``attn_impl="srf"``: the per-request state is one constant-size page
  {"s": (Hq, m, dv), "z": (Hq, m)} at the request's slot. Decode
  (C == 1) runs the fused CUDA srf_decode kernel; chunked prefill
  (C > 1) is plain einsum math, as in the reference. Seeded SRF
  (``SRFAttnConfig(seeded=True)``) takes the layer's seeds folded with
  the per-request embed seeds from ``cache["srf_folded"]``: the feature
  maps then run one zero-storage projection per (head, request) through
  the seeded spinner kernel. In training, the feature maps (the spinner
  kernels under autograd, ``kernels.ops``) feed
  ``srf_attention.attention_causal``.

Not ported yet (they raise NotImplementedError): MLA, cross attention,
M-RoPE, mesh tensor parallelism (``tp_axis``) and the encoder, prefill
and decode modes of the non-paged cache.

Unlike the reference, which returns new pools, both paged paths write
into the pool IN PLACE (the pool is the engine's preallocated buffer;
nothing else holds a view of those rows).
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.core import srf_attention as srf
from repro_torch.core.srf_attention import SRFConfig
from repro_torch.core.transforms import is_pow2
from repro_torch.kernels import ops as kops

from . import layers

NOT_IN_SLICE = ("not ported yet: the PyTorch port serves the dense "
                "full-KV and SRF families only (ROADMAP.md, 'Port state')")


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
    """(B, Hkv, ...) -> (B, Hkv*g, ...): each head repeated g times in
    place (an expand, so its backward is a sum, not an index_add)."""
    b, h = x.shape[:2]
    return x[:, :, None].expand(b, h, g, *x.shape[2:]).reshape(
        b, h * g, *x.shape[2:])


ATTN_Q_CHUNK = 1024   # query-chunked attention block (memory: qc*S probs
                      # instead of L*S; the chunk body is recomputed)


def _attn_block(qg: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                scale: float, mask) -> torch.Tensor:
    """qg: (B, Hkv, G, qc, hd); mask: (qc, S) or None -> (..., qc, dv).
    Scores and softmax in f32; the probabilities are cast back to v's
    dtype for the value product, as in the reference."""
    logits = torch.einsum("bhgld,bhsd->bhgls", qg.float(), k.float()) * scale
    if mask is not None:
        logits = torch.where(mask, logits, -1e30)
    w = torch.softmax(logits, dim=-1).to(v.dtype)
    return torch.einsum("bhgls,bhsd->bhgld", w, v)


def _softmax_attn(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  scale: float, causal: bool,
                  q_chunk: int = ATTN_Q_CHUNK) -> torch.Tensor:
    """q: (B, Hq, L, hd), k, v: (B, Hkv, S, hd) -> (B, Hq, L, dv); GQA by
    head grouping. A query axis longer than ``q_chunk`` (and a multiple
    of it) runs in chunks, each recomputed in the backward
    (``torch.utils.checkpoint``), so one (qc, S) probability block is the
    only live attention buffer."""
    b, hq, l, hd = q.shape
    hkv, s, dv = k.shape[1], k.shape[2], v.shape[-1]
    qg = q.reshape(b, hkv, hq // hkv, l, hd)
    cols = torch.arange(s, device=q.device)[None, :]
    if l <= q_chunk or l % q_chunk:
        mask = None
        if causal:
            mask = torch.arange(l, device=q.device)[:, None] + (s - l) >= cols
        out = _attn_block(qg, k, v, scale, mask)
        return out.reshape(b, hq, l, dv).to(q.dtype)
    outs = []
    for off in range(0, l, q_chunk):
        mask = None
        if causal:
            rows = off + torch.arange(q_chunk, device=q.device)[:, None]
            mask = rows + (s - l) >= cols
        outs.append(checkpoint(_attn_block, qg[:, :, :, off:off + q_chunk],
                               k, v, scale, mask, use_reentrant=False))
    return torch.cat(outs, dim=3).reshape(b, hq, l, dv).to(q.dtype)


def _paged_scatter(pool_arr: torch.Tensor, new: torch.Tensor,
                   tables: torch.Tensor, positions: torch.Tensor,
                   q_valid: torch.Tensor) -> None:
    """Write per-token rows into cache pages, in place.

    pool_arr: (N, P, ...) pages; new: (B, C, ...) one row per token;
    tables: (B, M) page ids; positions: (B, C) absolute positions. The
    page lookup clamps to the table width, as the reference's does.
    Invalid tokens (q_valid False) are written to row ``position % P`` of
    the reserved null page 0 instead of being dropped: the shapes stay
    static (a boolean-mask index would sync the host every layer), and
    no live request reads page 0 unmasked — it backs only the unused
    tail of a table, whose columns lie past every row's position."""
    n, p = pool_arr.shape[:2]
    m = tables.shape[1]
    page = torch.gather(tables, 1, (positions // p).clamp(0, m - 1).long())
    dest = torch.where(q_valid, page * p + positions % p, positions % p)
    flat = pool_arr.view((n * p,) + tuple(pool_arr.shape[2:]))
    flat.index_copy_(0, dest.reshape(-1).long(),
                     new.reshape((-1,) + tuple(new.shape[2:]))
                     .to(pool_arr.dtype))


def _flat_pages(pool_arr: torch.Tensor) -> torch.Tensor:
    """(N, P, ...) -> (N, P, D): a view, never a copy of the pool."""
    n, p = pool_arr.shape[:2]
    return pool_arr.view(n, p, -1)


def _paged_hist(pool_arr: torch.Tensor, tables: torch.Tensor
                ) -> torch.Tensor:
    """Request-contiguous history: (N, P, ...) + (B, M) -> (B, M*P, ...)
    through the paged_gather kernel."""
    hist = kops.paged_gather(_flat_pages(pool_arr), tables)
    return hist.view((tables.shape[0], -1) + tuple(pool_arr.shape[2:]))


def _paged_hist_dq_kv(pool: Dict[str, torch.Tensor], tables: torch.Tensor,
                      dtype) -> Tuple[torch.Tensor, torch.Tensor]:
    """int8 variant of :func:`_paged_hist` for a layer's K and V: (N, P,
    ...) int8 pages and (N, P, 1) f32 scales of each -> two (B, M*P, ...)
    ``dtype`` histories, the dequant fused into the gather (one
    paged_gather_dequant launch for both)."""
    k, v = kops.paged_gather_dequant_kv(
        _flat_pages(pool["k"]), pool["k_scale"], _flat_pages(pool["v"]),
        pool["v_scale"], tables, out_dtype=dtype)
    shape = (tables.shape[0], -1) + tuple(pool["k"].shape[2:])
    return k.view(shape), v.view(shape)


def _quantize_paged_kv(x: torch.Tensor):
    """(B, C, Hkv, hd) chunk rows -> (int8 rows, (B, C, 1) f32 scales):
    one scale per cached token, max|x| / 127 floored at 1e-8, values
    rounded half to even and clipped to +-127."""
    xf = x.float()
    mx = xf.abs().amax(dim=(-2, -1))
    s = torch.clamp(mx / 127.0, min=1e-8)[..., None]           # (B, C, 1)
    q = torch.clamp(torch.round(xf / s[..., None]), -127, 127)
    return q.to(torch.int8), s


def _paged_softmax(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   scale: float, positions: torch.Tensor) -> torch.Tensor:
    """Batched chunk attention against gathered pages.

    q: (B, Hq, C, hd); k, v: (B, Hkv, T, hd); positions: (B, C). Column t
    is visible to chunk row i iff t <= positions[:, i] (the new tokens
    were scattered into the history first, so the diagonal is included).
    Logits and softmax in f32, masked with -1e30; the weights are cast to
    v's dtype for the value product, as in the reference."""
    b, hq, c, hd = q.shape
    hkv, t = k.shape[1], k.shape[2]
    qg = q.reshape(b, hkv, hq // hkv, c, hd)
    logits = torch.einsum("bhgld,bhsd->bhgls", qg.float(), k.float()) * scale
    cols = torch.arange(t, device=q.device)
    mask = (cols[None, :] <= positions.reshape(b * c, 1)).view(b, 1, 1, c, t)
    logits = torch.where(mask, logits, -1e30)
    w = torch.softmax(logits, dim=-1).to(v.dtype)
    out = torch.einsum("bhgls,bhsd->bhgld", w, v)
    return out.reshape(b, hq, c, v.shape[-1]).to(q.dtype)


def _paged_full(cfg, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                positions: torch.Tensor, ctx: Dict) -> torch.Tensor:
    """Full-KV paged path: scatter the chunk's k/v into the pages (in
    place), gather the whole table width (M*P columns), attend. Decode
    (C=1) and chunked prefill alike; bf16/f32 pools, or int8 pools
    (detected by their scale leaves) with the dequant fused into the
    gather."""
    pool, tables, q_valid = ctx["pool"], ctx["tables"], ctx["q_valid"]
    kt = k.transpose(1, 2)                             # (B, C, Hkv, hd)
    vt = v.transpose(1, 2)
    if "k_scale" in pool:
        for name, rows in (("k", kt), ("v", vt)):
            qr, sc = _quantize_paged_kv(rows)
            _paged_scatter(pool[name], qr, tables, positions, q_valid)
            _paged_scatter(pool[f"{name}_scale"], sc, tables, positions,
                           q_valid)
        kf, vf = _paged_hist_dq_kv(pool, tables, q.dtype)
    else:
        _paged_scatter(pool["k"], kt, tables, positions, q_valid)
        _paged_scatter(pool["v"], vt, tables, positions, q_valid)
        kf = _paged_hist(pool["k"], tables)
        vf = _paged_hist(pool["v"], tables)
    kf = kf.transpose(1, 2).to(q.dtype)                # (B, Hkv, T, hd)
    vf = vf.transpose(1, 2).to(q.dtype)
    return _paged_softmax(q, kf, vf, 1.0 / math.sqrt(cfg.head_dim),
                          positions)


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
              cache: Optional[Dict] = None) -> torch.Tensor:
    """GQA attention: (B, L, d) -> (B, L, d).

    ``mode="paged"``: one serving step; ``cache["pool"]`` is the layer's
    KV page pool (full) or slot pool (srf), updated in place.
    ``mode="train"``: causal attention over the whole sequence, no cache
    (full softmax, or SRF's causal linear attention)."""
    if mode not in ("paged", "train"):
        raise NotImplementedError(f"attention mode {mode!r} is "
                                  f"{NOT_IN_SLICE}")
    if cfg.is_mla:
        raise NotImplementedError(f"MLA attention is {NOT_IN_SLICE}")
    if cache is not None and cache.get("tp_axis"):
        raise NotImplementedError(f"tensor-parallel attention (tp_axis) is "
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
    if cfg.attn_impl != "srf":
        if mode == "train":
            out = _softmax_attn(q, k, v, 1.0 / math.sqrt(cfg.head_dim),
                                causal=True)
        else:
            out = _paged_full(cfg, q, k, v, positions, cache)
        return _merge_heads(out) @ p["wo"]

    sc = srf_cfg(cfg)
    g = cfg.n_heads // cfg.n_kv_heads
    b, hq, l, hd = q.shape
    qg = q.reshape(b, cfg.n_kv_heads, g * l, hd)
    folded = None if cache is None else cache.get("srf_folded")
    if folded is None:                       # per-(head, request) seeds
        phi_q = srf.feature_map(sc, p["srf"], qg, is_query=True)
        phi_k = srf.feature_map(sc, p["srf"], k, is_query=False)
    else:
        phi_q = srf.feature_map_folded(sc, folded, qg, is_query=True)
        phi_k = srf.feature_map_folded(sc, folded, k, is_query=False)
    phi_q = phi_q.reshape(b, hq, l, -1)
    phi_k = _repeat_kv(phi_k, g)
    if mode == "train":
        out = srf.attention_causal(sc, phi_q, phi_k, _repeat_kv(v, g))
    else:
        out = _paged_srf(cache["pool"], cache["slots"], phi_q, phi_k,
                         _repeat_kv(v, g), cache["q_valid"])
    return _merge_heads(out) @ p["wo"]
