"""GQA attention: the paged serving engine's step (full-KV pages or the
paper's SRF state), the training forward, and the per-request cache of
the legacy engine (prefill and decode).

Port of ``repro.models.attention``: ``srf_cfg``, ``attn_init``,
``init_cache``, ``_quantize_kv``, ``_dequantize_kv`` and ``attention``
in modes ``"paged"``, ``"train"``, ``"prefill"`` and ``"decode"``.

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

* Prefill and decode (``init_cache``): one contiguous cache a request
  batch. Full KV: {"k", "v": (B, Hkv, S, hd)} in the params' dtype, or
  int8 with one f32 scale per token and head ({"k_scale", "v_scale":
  (B, Hkv, S, 1)}) when ``cfg.kv_cache_dtype == "int8"``; prefill
  attends causally over the prompt and writes the cache from position
  0, decode writes one row at ``idx``, dequantizes the whole cache and
  attends over ``arange(S) <= idx``. SRF: {"s": (B, Hq, m, dv), "z":
  (B, Hq, m)} in the params' dtype; prefill runs
  ``srf_attention.attention_causal`` and stores ``prefill_state`` cast
  to v's dtype, decode runs ``srf_attention.decode_step`` in the
  state's own dtype (the reference's rounding, not ``_paged_srf``'s f32
  update). Plain PyTorch ops but the SRF feature maps (the spinner
  kernels), as the reference's are jnp ops.

Not ported yet (they raise NotImplementedError): MLA, cross attention,
M-RoPE, mesh tensor parallelism (``tp_axis``) and the encoder mode.

Unlike the reference, which returns new pools and caches, every cached
path writes IN PLACE and ``attention`` returns the output alone: the
paged paths into the engine's preallocated pools (nothing else holds a
view of those rows), prefill and decode into the buffers of
``init_cache``. The cache's position ``cache["idx"]`` is a host int,
advanced in the dict (prefill sets it to the prompt length, decode adds
one), so a decode step builds its mask and write offset without a host
sync; the reference keeps it as a 0-d int32 array.
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

NOT_IN_SLICE = ("not ported yet: the PyTorch port runs the dense, SSD "
                "and hybrid families with full-KV or SRF attention "
                "(ROADMAP.md, 'Port state')")


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


def init_cache(cfg, batch: int, max_len: int, dtype, device=None,
               lead=()) -> Dict:
    """The prefill / decode cache of ``batch`` requests (module
    docstring), zero-filled on ``device``; ``lead`` stacks a leading
    layer axis on every buffer. ``idx`` (a host int) starts at 0."""
    def zeros(*shape, dt=dtype):
        return torch.zeros((*lead, *shape), dtype=dt, device=device)
    if cfg.attn_impl == "srf":
        m = srf_cfg(cfg).feat_dim
        return {"s": zeros(batch, cfg.n_heads, m, cfg.head_dim),
                "z": zeros(batch, cfg.n_heads, m), "idx": 0}
    if cfg.is_mla:
        raise NotImplementedError(f"MLA attention is {NOT_IN_SLICE}")
    shp = (batch, cfg.n_kv_heads, max_len, cfg.head_dim)
    if cfg.kv_cache_dtype == "int8":
        return {"k": zeros(*shp, dt=torch.int8),
                "v": zeros(*shp, dt=torch.int8),
                "k_scale": zeros(*shp[:-1], 1, dt=torch.float32),
                "v_scale": zeros(*shp[:-1], 1, dt=torch.float32), "idx": 0}
    return {"k": zeros(*shp), "v": zeros(*shp), "idx": 0}


def _quantize_kv(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(B, H, L, hd) -> (int8 values, (B, H, L, 1) f32 scales): one scale
    per token and head, max|x| / 127 floored at 1e-8, values rounded half
    to even and clipped to +-127."""
    xf = x.float()
    s = torch.clamp(xf.abs().amax(dim=-1, keepdim=True) / 127.0, min=1e-8)
    q = torch.clamp(torch.round(xf / s), -127, 127)
    return q.to(torch.int8), s


def _dequantize_kv(q: torch.Tensor, s: torch.Tensor, dtype) -> torch.Tensor:
    return (q.float() * s).to(dtype)


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
                  kv_valid: Optional[torch.Tensor] = None,
                  q_chunk: int = ATTN_Q_CHUNK) -> torch.Tensor:
    """q: (B, Hq, L, hd), k, v: (B, Hkv, S, hd) -> (B, Hq, L, dv); GQA by
    head grouping. ``kv_valid`` (S,) bool masks cache columns out (with
    the causal mask, where both are asked). A query axis longer than
    ``q_chunk`` (and a multiple of it) runs in chunks, each recomputed in
    the backward (``torch.utils.checkpoint``), so one (qc, S) probability
    block is the only live attention buffer."""
    b, hq, l, hd = q.shape
    hkv, s, dv = k.shape[1], k.shape[2], v.shape[-1]
    qg = q.reshape(b, hkv, hq // hkv, l, hd)
    cols = torch.arange(s, device=q.device)[None, :]
    base = None if kv_valid is None else kv_valid[None, :]     # (1, S)

    def mask_of(rows):
        if not causal:
            return base
        tri = rows + (s - l) >= cols
        return tri if base is None else tri & base
    if l <= q_chunk or l % q_chunk:
        mask = mask_of(torch.arange(l, device=q.device)[:, None])
        out = _attn_block(qg, k, v, scale, mask)
        return out.reshape(b, hq, l, dv).to(q.dtype)
    outs = []
    for off in range(0, l, q_chunk):
        mask = mask_of(off + torch.arange(q_chunk, device=q.device)[:, None])
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


def _write_rows(cache: Dict[str, torch.Tensor], k: torch.Tensor,
                v: torch.Tensor, start: int) -> None:
    """Write k, v (B, Hkv, L, hd) into the cache at rows start.. (in
    place; quantized first for an int8 cache). Like the reference's
    ``dynamic_update_slice``, a start past the end is clamped so the L
    rows fit."""
    start = min(max(start, 0), cache["k"].shape[2] - k.shape[2])
    rows = slice(start, start + k.shape[2])
    for name, t in (("k", k), ("v", v)):
        if f"{name}_scale" in cache:
            t, sc = _quantize_kv(t)
            cache[f"{name}_scale"][:, :, rows] = sc
        cache[name][:, :, rows] = t.to(cache[name].dtype)


def _full_cached(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 scale: float, mode: str, cache: Dict) -> torch.Tensor:
    """Full-KV prefill (causal over the prompt, the cache written from
    row 0) or decode (one row written at ``idx``, attention over rows
    0..idx of the whole, dequantized cache)."""
    if mode == "prefill":
        _write_rows(cache, k, v, 0)
        cache["idx"] = k.shape[2]
        return _softmax_attn(q, k, v, scale, causal=True)
    idx = cache["idx"]
    _write_rows(cache, k, v, idx)
    cache["idx"] = idx + 1
    if "k_scale" in cache:
        kf = _dequantize_kv(cache["k"], cache["k_scale"], q.dtype)
        vf = _dequantize_kv(cache["v"], cache["v_scale"], q.dtype)
    else:
        kf, vf = cache["k"], cache["v"]
    valid = torch.arange(kf.shape[2], device=q.device) <= idx
    return _softmax_attn(q, kf, vf, scale, causal=False, kv_valid=valid)


def _srf_cached(sc: SRFConfig, phi_q: torch.Tensor, phi_k: torch.Tensor,
                v: torch.Tensor, mode: str, cache: Dict) -> torch.Tensor:
    """SRF prefill (causal linear attention over the prompt; the state
    ``prefill_state`` cast to v's dtype) or decode (``decode_step`` on
    the state in its own dtype); the state is written in place."""
    if mode == "prefill":
        out = srf.attention_causal(sc, phi_q, phi_k, v)
        s, z = srf.prefill_state(phi_k, v)
        cache["s"].copy_(s.to(v.dtype))
        cache["z"].copy_(z.to(v.dtype))
        cache["idx"] = phi_k.shape[2]
        return out
    (s, z), out = srf.decode_step((cache["s"], cache["z"]), phi_q, phi_k, v)
    cache["s"].copy_(s)
    cache["z"].copy_(z)
    cache["idx"] += 1
    return out


def attention(p, cfg, x: torch.Tensor, positions: torch.Tensor, mode: str,
              cache: Optional[Dict] = None) -> torch.Tensor:
    """GQA attention: (B, L, d) -> (B, L, d).

    ``mode="paged"``: one serving step; ``cache["pool"]`` is the layer's
    KV page pool (full) or slot pool (srf), updated in place.
    ``mode="train"``: causal attention over the whole sequence, no cache
    (full softmax, or SRF's causal linear attention).
    ``mode="prefill"`` / ``"decode"``: the prompt, or one new token, of
    every request of a batch against ``cache`` (``init_cache``), which
    is written in place and its ``idx`` advanced."""
    if mode not in ("paged", "train", "prefill", "decode"):
        raise NotImplementedError(f"attention mode {mode!r} is "
                                  f"{NOT_IN_SLICE}")
    if mode != "train" and cache is None:
        raise ValueError(f"attention mode {mode!r} needs a cache")
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
        scale = 1.0 / math.sqrt(cfg.head_dim)
        if mode == "train":
            out = _softmax_attn(q, k, v, scale, causal=True)
        elif mode == "paged":
            out = _paged_full(cfg, q, k, v, positions, cache)
        else:
            out = _full_cached(q, k, v, scale, mode, cache)
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
    vr = _repeat_kv(v, g)
    if mode == "train":
        out = srf.attention_causal(sc, phi_q, phi_k, vr)
    elif mode == "paged":
        out = _paged_srf(cache["pool"], cache["slots"], phi_q, phi_k, vr,
                         cache["q_valid"])
    else:
        out = _srf_cached(sc, phi_q, phi_k, vr, mode, cache)
    return _merge_heads(out) @ p["wo"]
