"""Attention: full softmax GQA, MLA (DeepSeek latent attention) and the
paper's SRF attention, for the paged serving engine's step, the training
forward, and the per-request cache of the legacy engine (prefill and
decode).

Port of ``repro.models.attention``: ``srf_cfg``, ``attn_init``,
``cross_attn_init``, ``init_cache``, ``_quantize_kv``,
``_dequantize_kv``, ``_mla_qkv``, ``attention`` in modes ``"paged"``,
``"train"``, ``"encoder"``, ``"prefill"`` and ``"decode"``,
``cross_attention`` and ``paged_cross_attention``.

* ``attn_impl="full"`` (the configs' default): the chunk's k/v rows are
  scattered into the request's KV pages (bf16/f32, or int8 with one f32
  scale per token), then the whole table width of K and V is gathered
  back in one launch of the paged_gather_kv / paged_gather_dequant_kv
  CUDA kernels and attended with an f32 softmax (``_paged_full``). In training, causal softmax
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
* MLA (``cfg.mla_kv_lora`` > 0, ``_mla_attention``): each token caches a
  latent c = x·wdkv (kv_lora wide) and a rope key kpe = x·wkpe (qk_rope
  wide, stored before RoPE); every step decompresses the whole history
  into per-head keys [c·wuk | rope(kpe)] and values c·wuv. Paged, the
  latents are scattered into their own pages (the ``mla`` family) and
  gathered back through one paged_gather_kv launch (rows of kv_lora and
  of qk_rope),
  the history roped at read time at positions 0..T-1; scale
  1/sqrt(qk_nope + qk_rope). With SRF, the chunk's own keys and values
  feed one P-model per query head, and the state is the SRF slot of
  dv = mla_v_dim.

* Prefill and decode (``init_cache``): one contiguous cache a request
  batch. Full KV: {"k", "v": (B, Hkv, S, hd)} in the params' dtype, or
  int8 with one f32 scale per token and head ({"k_scale", "v_scale":
  (B, Hkv, S, 1)}) when ``cfg.kv_cache_dtype == "int8"``; prefill
  attends causally over the prompt and writes the cache from position
  0, decode writes one row at ``idx``, dequantizes the whole cache and
  attends over ``arange(S) <= idx``. MLA: {"c": (B, S, kv_lora), "kpe":
  (B, S, qk_rope)}, the same rule. SRF: {"s": (B, Hq, m, dv), "z":
  (B, Hq, m)} in the params' dtype; prefill runs
  ``srf_attention.attention_causal`` and stores ``prefill_state`` cast
  to v's dtype, decode runs ``srf_attention.decode_step`` in the
  state's own dtype (the reference's rounding, not ``_paged_srf``'s f32
  update). Plain PyTorch ops but the SRF feature maps (the spinner
  kernels), as the reference's are jnp ops.

M-RoPE (``cfg.m_rope``, qwen2-vl) rotates q and k by the (t, h, w)
rows of ``pos3`` wherever a batch carries them (training, and the
prefill of a batch with ``pos3``); the serving paths get none and use
1-D RoPE, as the reference's. Mode ``"encoder"`` is the enc-dec
encoder's bidirectional attention (softmax, or SRF's
``attention_noncausal``); ``cross_attention`` and
``paged_cross_attention`` attend an enc-dec decoder layer to the
encoder memory.

Mesh tensor parallelism (``cache["tp_axis"]`` in paged mode, the
``tp_axis`` of ``cross_attention``; a ``distributed.collectives.Axis``):
``p`` and the pools are then per-shard lists (one tree a position of the
axis) and ``cfg`` the shard-local config (``serving.mesh.shard.local_cfg``).
Each shard projects, caches and attends its own heads through its own
column-parallel wq / wk / wv and pools (the kernels run at the local
shapes), the head outputs are stitched in shard order
(``collectives.stitch_heads``) and the replicated wo contracts them on
the home device, in the single-device order. Int8 pages take one scale
a token over ALL heads: the row maxima are the max over the shards'
(``collectives.pmax``), so every shard stores the same scale.

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
from repro_torch.distributed import collectives
from repro_torch.distributed.collectives import stitch_heads  # noqa: F401
from repro_torch.kernels import ops as kops

from . import layers

def v_dim(cfg) -> int:
    """Width of a head's value (the SRF state's dv)."""
    return cfg.mla_v_dim if cfg.is_mla else cfg.head_dim


def srf_cfg(cfg) -> SRFConfig:
    dim = cfg.mla_qk_dim if cfg.is_mla else cfg.head_dim
    return SRFConfig(kind=cfg.srf.kind, n_features=cfg.srf.n_features,
                     head_dim=dim, feature=cfg.srf.feature, r=cfg.srf.r,
                     use_hd=is_pow2(dim), chunk=cfg.srf.chunk,
                     seeded=cfg.srf.seeded)


def attn_init(gen: torch.Generator, cfg, dtype, device=None,
              lead=()) -> Dict:
    """Attention params; ``lead`` stacks a leading layer axis. MLA:
    "wq", "wdkv", "wkpe", "wuk", "wuv", "wo"; SRF P-models one per kv
    head, or one per query head under MLA."""
    d = cfg.d_model

    def dense(i, o):
        return layers.dense_init(gen, i, o, dtype, device, lead=lead)
    if cfg.is_mla:
        h = cfg.n_heads
        p: Dict = {"wq": dense(d, h * cfg.mla_qk_dim),
                   "wdkv": dense(d, cfg.mla_kv_lora),
                   "wkpe": dense(d, cfg.mla_qk_rope),
                   "wuk": dense(cfg.mla_kv_lora, h * cfg.mla_qk_nope),
                   "wuv": dense(cfg.mla_kv_lora, h * cfg.mla_v_dim),
                   "wo": dense(h * cfg.mla_v_dim, d)}
    else:
        p = {"wq": dense(d, cfg.q_dim), "wk": dense(d, cfg.kv_dim),
             "wv": dense(d, cfg.kv_dim), "wo": dense(cfg.q_dim, d)}
    if cfg.qkv_bias and not cfg.is_mla:
        for name, dim in (("bq", cfg.q_dim), ("bk", cfg.kv_dim),
                          ("bv", cfg.kv_dim)):
            p[name] = torch.zeros((*lead, dim), dtype=dtype, device=device)
    if cfg.qk_norm:
        hd = cfg.mla_qk_dim if cfg.is_mla else cfg.head_dim
        p["q_norm"] = torch.ones((*lead, hd), dtype=dtype, device=device)
        p["k_norm"] = torch.ones((*lead, hd), dtype=dtype, device=device)
    if cfg.attn_impl == "srf":
        sc = srf_cfg(cfg)
        n_pm = cfg.n_heads if cfg.is_mla else cfg.n_kv_heads
        per_layer = [srf.init(gen, sc, n_pm, dtype, device)
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
        return {"s": zeros(batch, cfg.n_heads, m, v_dim(cfg)),
                "z": zeros(batch, cfg.n_heads, m), "idx": 0}
    if cfg.is_mla:
        return {"c": zeros(batch, max_len, cfg.mla_kv_lora),
                "kpe": zeros(batch, max_len, cfg.mla_qk_rope), "idx": 0}
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


def _paged_hist_kv(pool_a: torch.Tensor, pool_b: torch.Tensor,
                   tables: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`_paged_hist` of a layer's two pools that share the table (K
    and V, or MLA's c and kpe; their rows may differ), in one
    paged_gather_kv launch."""
    a, b = kops.paged_gather_kv(_flat_pages(pool_a), _flat_pages(pool_b),
                                tables)
    lead = (tables.shape[0], -1)
    return (a.view(lead + tuple(pool_a.shape[2:])),
            b.view(lead + tuple(pool_b.shape[2:])))


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


def _row_absmax(x: torch.Tensor) -> torch.Tensor:
    """(B, C, H, hd) chunk rows -> (B, C) f32 max|x| over heads and dims."""
    return x.float().abs().amax(dim=(-2, -1))


def _quantize_paged_kv(x: torch.Tensor, mx: Optional[torch.Tensor] = None):
    """(B, C, Hkv, hd) chunk rows -> (int8 rows, (B, C, 1) f32 scales):
    one scale per cached token, max|x| / 127 floored at 1e-8, values
    rounded half to even and clipped to +-127. ``mx`` (B, C): the row
    maxima over every head, where ``x`` holds one shard's heads."""
    xf = x.float()
    if mx is None:
        mx = _row_absmax(x)
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
                positions: torch.Tensor, ctx: Dict,
                absmax: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
                ) -> torch.Tensor:
    """Full-KV paged path: scatter the chunk's k/v into the pages (in
    place), gather the whole table width (M*P columns), attend. Decode
    (C=1) and chunked prefill alike; bf16/f32 pools, or int8 pools
    (detected by their scale leaves) with the dequant fused into the
    gather. ``absmax``: the k and v row maxima over all heads (a
    shard's call under tensor parallelism)."""
    pool, tables, q_valid = ctx["pool"], ctx["tables"], ctx["q_valid"]
    kt = k.transpose(1, 2)                             # (B, C, Hkv, hd)
    vt = v.transpose(1, 2)
    if "k_scale" in pool:
        for j, (name, rows) in enumerate((("k", kt), ("v", vt))):
            qr, sc = _quantize_paged_kv(
                rows, None if absmax is None else absmax[j])
            _paged_scatter(pool[name], qr, tables, positions, q_valid)
            _paged_scatter(pool[f"{name}_scale"], sc, tables, positions,
                           q_valid)
        kf, vf = _paged_hist_dq_kv(pool, tables, q.dtype)
    else:
        _paged_scatter(pool["k"], kt, tables, positions, q_valid)
        _paged_scatter(pool["v"], vt, tables, positions, q_valid)
        kf, vf = _paged_hist_kv(pool["k"], pool["v"], tables)
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


def _feature_maps(sc: SRFConfig, p, cache: Optional[Dict],
                  q: torch.Tensor, k: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """SRF features of queries (B, G, Lq, n) and keys (B, G, Lk, n), one
    P-model per group: the layer's own, or its seeds folded with the
    step's embed seeds (``cache["srf_folded"]``, seeded SRF)."""
    folded = None if cache is None else cache.get("srf_folded")
    if folded is None:
        return (srf.feature_map(sc, p["srf"], q, is_query=True),
                srf.feature_map(sc, p["srf"], k, is_query=False))
    return (srf.feature_map_folded(sc, folded, q, is_query=True),
            srf.feature_map_folded(sc, folded, k, is_query=False))


def _qkv(p, cfg, x: torch.Tensor, positions: torch.Tensor,
         pos3: Optional[torch.Tensor] = None
         ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Roped, normed per-head q (B, Hq, L, hd), k, v (B, Hkv, L, hd)."""
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
    if cfg.m_rope and pos3 is not None:
        q = layers.apply_m_rope(q, pos3, cfg.rope_theta, cfg.m_rope_sections)
        k = layers.apply_m_rope(k, pos3, cfg.rope_theta, cfg.m_rope_sections)
    else:
        q = layers.apply_rope(q, positions, cfg.rope_theta)
        k = layers.apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def _srf_heads(p, cfg, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               mode: str, cache: Optional[Dict]) -> torch.Tensor:
    """SRF attention of roped q, k, v in every mode -> (B, Hq, L, dv)."""
    sc = srf_cfg(cfg)
    g = cfg.n_heads // cfg.n_kv_heads
    b, hq, l, hd = q.shape
    phi_q, phi_k = _feature_maps(sc, p, cache,
                                 q.reshape(b, cfg.n_kv_heads, g * l, hd), k)
    phi_q = phi_q.reshape(b, hq, l, -1)
    phi_k = _repeat_kv(phi_k, g)
    vr = _repeat_kv(v, g)
    if mode == "train":
        return srf.attention_causal(sc, phi_q, phi_k, vr)
    if mode == "encoder":
        return srf.attention_noncausal(phi_q, phi_k, vr)
    if mode == "paged":
        return _paged_srf(cache["pool"], cache["slots"], phi_q, phi_k, vr,
                          cache["q_valid"])
    return _srf_cached(sc, phi_q, phi_k, vr, mode, cache)


def attention(p, cfg, x: torch.Tensor, positions: torch.Tensor, mode: str,
              cache: Optional[Dict] = None,
              pos3: Optional[torch.Tensor] = None) -> torch.Tensor:
    """GQA or MLA attention: (B, L, d) -> (B, L, d).

    ``mode="paged"``: one serving step; ``cache["pool"]`` is the layer's
    KV page pool (full), latent page pool (MLA) or slot pool (srf),
    updated in place; with ``cache["tp_axis"]``, per-shard lists of
    params and pools (module docstring).
    ``mode="train"``: causal attention over the whole sequence, no cache
    (full softmax, or SRF's causal linear attention); ``"encoder"``: the
    same, bidirectional (softmax, or ``srf.attention_noncausal``).
    ``mode="prefill"`` / ``"decode"``: the prompt, or one new token, of
    every request of a batch against ``cache`` (``init_cache``), which
    is written in place and its ``idx`` advanced.
    ``pos3`` (3, B, L): the (t, h, w) position rows of an M-RoPE config
    (``layers.apply_m_rope``); without it, or for another config, 1-D
    RoPE at ``positions``."""
    if mode not in ("paged", "train", "encoder", "prefill", "decode"):
        raise ValueError(f"attention mode {mode!r}")
    if mode not in ("train", "encoder") and cache is None:
        raise ValueError(f"attention mode {mode!r} needs a cache")
    if cache is not None and cache.get("tp_axis") is not None:
        if mode != "paged":
            raise ValueError(f"tensor-parallel attention (tp_axis) serves "
                             f"the paged step only, not mode {mode!r}")
        return _attention_tp(p, cfg, x, positions, cache)
    if cfg.is_mla:
        return _merge_heads(_mla_attention(p, cfg, x, positions, mode,
                                           cache)) @ p["wo"]
    q, k, v = _qkv(p, cfg, x, positions, pos3)
    if cfg.attn_impl == "srf":
        return _merge_heads(_srf_heads(p, cfg, q, k, v, mode, cache)) \
            @ p["wo"]
    scale = 1.0 / math.sqrt(cfg.head_dim)
    if mode in ("train", "encoder"):
        out = _softmax_attn(q, k, v, scale, causal=mode == "train")
    elif mode == "paged":
        out = _paged_full(cfg, q, k, v, positions, cache)
    else:
        out = _full_cached(q, k, v, scale, mode, cache)
    return _merge_heads(out) @ p["wo"]


def _attention_tp(ps, cfg, x: torch.Tensor, positions: torch.Tensor,
                  ctx: Dict) -> torch.Tensor:
    """The paged step's attention over a mesh axis: each shard's heads
    through its own params and pools (``ps``, ``ctx["pool"]`` and
    ``ctx["srf_folded"]`` are per-shard lists; the rest of ``ctx``, x
    and positions replicated), the head outputs stitched in shard order
    and contracted with the replicated wo on the home device."""
    axis = ctx["tp_axis"]
    run = collectives.axis_shard_map
    xs = collectives.broadcast(x, axis)
    rest = collectives.broadcast(
        {"positions": positions, "tables": ctx["tables"],
         "slots": ctx["slots"], "q_valid": ctx["q_valid"]}, axis)
    folded = ctx.get("srf_folded") or [None] * axis.size
    ctxs = [{**r, "pool": pool, **({} if f is None else {"srf_folded": f})}
            for r, pool, f in zip(rest, ctx["pool"], folded)]
    if cfg.is_mla:
        heads = run(lambda p, xx, c: _mla_attention(
            p, cfg, xx, c["positions"], "paged", c), axis)(ps, xs, ctxs)
    else:
        qkv = run(lambda p, xx, c: _qkv(p, cfg, xx, c["positions"]),
                  axis)(ps, xs, ctxs)
        if cfg.attn_impl == "srf":
            heads = run(lambda p, t, c: _srf_heads(p, cfg, *t, "paged", c),
                        axis)(ps, qkv, ctxs)
        else:
            absmax = [None] * axis.size
            if "k_scale" in ctxs[0]["pool"]:
                kmax = collectives.pmax(
                    [_row_absmax(k.transpose(1, 2)) for _, k, _ in qkv], axis)
                vmax = collectives.pmax(
                    [_row_absmax(v.transpose(1, 2)) for _, _, v in qkv], axis)
                absmax = collectives.broadcast((kmax, vmax), axis)
            heads = run(lambda t, c, am: _paged_full(
                cfg, *t, c["positions"], c, am), axis)(qkv, ctxs, absmax)
    return _merge_heads(collectives.stitch_heads(heads, axis)) @ ps[0]["wo"]


def _mla_qkv(p, cfg, x: torch.Tensor, c: torch.Tensor, kpe: torch.Tensor,
             positions: torch.Tensor, kpos: Optional[torch.Tensor] = None
             ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Roped queries (B, H, L, qk) of x, and the per-head keys (B, H, S,
    qk) and values (B, H, S, v) decompressed from the latents c (B, S,
    kv_lora) and kpe (B, S, qk_rope), kpe roped at ``kpos`` (default
    ``positions``); qk = qk_nope + qk_rope."""
    b, s = c.shape[:2]
    h = cfg.n_heads
    q = _split_heads(x @ p["wq"], h, cfg.mla_qk_dim)
    if cfg.qk_norm:
        q = layers.head_rmsnorm(p["q_norm"], q, cfg.norm_eps)
    qn, qp = q.split([cfg.mla_qk_nope, cfg.mla_qk_rope], dim=-1)
    qp = layers.apply_rope(qp, positions, cfg.rope_theta)
    kn = _split_heads(c @ p["wuk"], h, cfg.mla_qk_nope)
    v = _split_heads(c @ p["wuv"], h, cfg.mla_v_dim)
    kp = layers.apply_rope(kpe[:, None], positions if kpos is None else kpos,
                           cfg.rope_theta)                  # (B, 1, S, rope)
    k = torch.cat([kn, kp.expand(b, h, s, cfg.mla_qk_rope)], dim=-1)
    return torch.cat([qn, qp], dim=-1), k, v


def _mla_attention(p, cfg, x: torch.Tensor, positions: torch.Tensor,
                   mode: str, cache: Optional[Dict]) -> torch.Tensor:
    """MLA in every mode -> per-head outputs (B, H, L, v) (module
    docstring)."""
    b, l, _ = x.shape
    scale = 1.0 / math.sqrt(cfg.mla_qk_dim)
    c_new = x @ p["wdkv"]                                  # (B, L, kv_lora)
    kpe_new = x @ p["wkpe"]                                # (B, L, rope)
    if cfg.attn_impl == "srf":
        # the chunk's own keys and values; the state carries the rest
        q, k, v = _mla_qkv(p, cfg, x, c_new, kpe_new, positions)
        sc = srf_cfg(cfg)
        phi_q, phi_k = _feature_maps(sc, p, cache, q, k)
        if mode == "train":
            return srf.attention_causal(sc, phi_q, phi_k, v)
        if mode == "paged":
            return _paged_srf(cache["pool"], cache["slots"], phi_q, phi_k,
                              v, cache["q_valid"])
        return _srf_cached(sc, phi_q, phi_k, v, mode, cache)
    if mode == "paged":
        pool, tables = cache["pool"], cache["tables"]
        for name, rows in (("c", c_new), ("kpe", kpe_new)):
            _paged_scatter(pool[name], rows, tables, positions,
                           cache["q_valid"])
        cc, kk = _paged_hist_kv(pool["c"], pool["kpe"], tables)
        cc, kk = cc.to(x.dtype), kk.to(x.dtype)
        t = cc.shape[1]
        kpos = torch.arange(t, device=x.device)[None].expand(b, t)
        q, k, v = _mla_qkv(p, cfg, x, cc, kk, positions, kpos)
        return _paged_softmax(q, k, v, scale, positions)
    if mode == "decode":
        idx = cache["idx"]
        smax = cache["c"].shape[1]
        at = min(max(idx, 0), smax - l)         # dynamic_update_slice's clamp
        cache["c"][:, at:at + l] = c_new.to(cache["c"].dtype)
        cache["kpe"][:, at:at + l] = kpe_new.to(cache["kpe"].dtype)
        cache["idx"] = idx + 1
        kpos = torch.arange(smax, device=x.device)[None].expand(b, smax)
        q, k, v = _mla_qkv(p, cfg, x, cache["c"], cache["kpe"], positions,
                           kpos)
        valid = torch.arange(smax, device=x.device) <= idx
        return _softmax_attn(q, k, v, scale, causal=False, kv_valid=valid)
    if mode == "prefill":
        cache["c"][:, :l] = c_new.to(cache["c"].dtype)
        cache["kpe"][:, :l] = kpe_new.to(cache["kpe"].dtype)
        cache["idx"] = l
    q, k, v = _mla_qkv(p, cfg, x, c_new, kpe_new, positions)
    return _softmax_attn(q, k, v, scale, causal=True)


def cross_attn_init(gen: torch.Generator, cfg, dtype, device=None,
                    lead=()) -> Dict:
    """Cross-attention params of an enc-dec decoder layer: "wq", "wk",
    "wv", "wo" (no biases, no norms, no RoPE)."""
    def dense(i, o):
        return layers.dense_init(gen, i, o, dtype, device, lead=lead)
    d = cfg.d_model
    return {"wq": dense(d, cfg.q_dim), "wk": dense(d, cfg.kv_dim),
            "wv": dense(d, cfg.kv_dim), "wo": dense(cfg.q_dim, d)}


def _cross_heads(p, cfg, x: torch.Tensor, memory: torch.Tensor
                 ) -> torch.Tensor:
    q = _split_heads(x @ p["wq"], cfg.n_heads, cfg.head_dim)
    k = _split_heads(memory @ p["wk"], cfg.n_kv_heads, cfg.head_dim)
    v = _split_heads(memory @ p["wv"], cfg.n_kv_heads, cfg.head_dim)
    return _softmax_attn(q, k, v, 1.0 / math.sqrt(cfg.head_dim),
                         causal=False)


def cross_attention(p, cfg, x: torch.Tensor, memory: torch.Tensor,
                    tp_axis: Optional[collectives.Axis] = None
                    ) -> torch.Tensor:
    """Exact softmax cross attention of x (B, L, d) over the encoder
    memory (B, E, d): keys and values are ``memory @ wk`` and ``memory
    @ wv``, recomputed at every call, as in the reference. With
    ``tp_axis``, ``p`` is a per-shard list (column-parallel wq / wk /
    wv, ``cfg`` shard-local): each shard attends its heads, stitched
    before the replicated wo."""
    if tp_axis is None:
        return _merge_heads(_cross_heads(p, cfg, x, memory)) @ p["wo"]
    heads = collectives.axis_shard_map(
        lambda pp, xx, mm: _cross_heads(pp, cfg, xx, mm), tp_axis)(
        p, collectives.broadcast(x, tp_axis),
        collectives.broadcast(memory, tp_axis))
    return _merge_heads(collectives.stitch_heads(heads, tp_axis)) \
        @ p[0]["wo"]


def paged_cross_attention(p, cfg, x: torch.Tensor, memory: torch.Tensor,
                          tp_axis: Optional[collectives.Axis] = None
                          ) -> torch.Tensor:
    """Cross attention of the paged engine's step: ``memory`` holds the
    batch rows' encoder memories, gathered from the read-only memory
    pool. The same math as :func:`cross_attention`, row by row."""
    return cross_attention(p, cfg, x, memory, tp_axis)
