"""Decoder LM of the dense, SSD, hybrid and MoE families: the paged
serving step, the legacy engine's prefill and decode, and the training
forward (full-KV, MLA or SRF attention; SSD blocks in ``models.ssm``,
expert FFNs in ``models.moe``).

Port of ``repro.models.transformer`` for the dense, ssm, hybrid and moe
families: ``init``,
``paged_step``, ``_paged_layer`` and ``_logits`` for the paged engine,
``init_serve_cache``, ``prefill``, ``decode_step`` and ``run_segment``
in modes ``"prefill"`` and ``"decode"`` for the legacy per-slot engine,
and ``layer_apply``, ``run_segment`` (mode ``"train"``),
``embed_inputs``, ``forward`` and ``loss_fn`` for training, as functions
over a param dict. The param tree has the reference's layout,
so ``repro_torch.convert.params_from_jax`` maps one onto the other leaf
for leaf:

    {"embed": {"tok": (V, d)},
     "segments": [{"ln1": {"w"}, "attn": {...}, "ln2": {"w"},
                   "mlp": {"wi", "wg", "wo"}}],      # leading layer axis L
     "final_norm": {"w": (d,)},
     "head": (d, V)}                                  # absent when tied

An ssm layer is {"ln1", "ssm"}; a hybrid layer is a dense layer with an
"ssm" block beside its attention and the two fusion norms "fuse_na" and
"fuse_ns" (``layer_apply``: 0.5 (rmsnorm(attn) + rmsnorm(ssm))). A moe
layer is a dense layer with "moe" (router, experts, shared experts) in
place of "mlp"; an MoE config's stack is ``cfg.moe_first_dense`` dense
layers, then a segment of moe layers.

Layers run as a Python loop over the stacked layer axis (the reference
scans). The serve cache of ``init_serve_cache`` is
{"segments": [per-segment buffers with a leading layer axis, and the
segment's position "idx"; a hybrid segment's is {"attn": ..., "ssm":
...}, each with its own "idx"], "pos"}, as the reference's, but written
in place by ``prefill`` and ``decode_step`` (which return it), with
"idx" and "pos" host ints (``attention.init_cache``,
``ssm.init_ssm_cache``). In training, each layer (or group of ``cfg.scan_group`` layers)
is recomputed in the backward as the config's ``remat`` says
(``torch.utils.checkpoint``, see ``_remat``). Attention is full-KV
(paged pools) or SRF (slot pools), as the config's ``attn_impl`` says;
SSD state lives in slot pools, MLA latents in paged pools of their
own. The enc-dec and vision families are not ported yet and raise
NotImplementedError.
"""
from __future__ import annotations

import functools
from typing import Dict, List, Optional, Tuple

import torch
from torch.utils import checkpoint as ckpt

from repro_torch import tree as tree_lib
from repro_torch.core import srf_attention as srf

from . import attention, hooks, layers, moe, ssm


def dtype_of(cfg) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def segments(cfg) -> List[Tuple[str, int]]:
    """[(layer_kind, count)] for the decoder stack."""
    if cfg.family == "ssm":
        return [("ssm", cfg.n_layers)]
    if cfg.family == "hybrid":
        return [("hybrid", cfg.n_layers)]
    if cfg.is_encdec or cfg.frontend != "none" or \
            cfg.family not in ("dense", "moe"):
        raise NotImplementedError(
            f"{cfg.name} ({cfg.family}) is {attention.NOT_IN_SLICE}")
    if cfg.is_moe:
        first = cfg.moe_first_dense
        return ([("dense", first)] if first else []) + \
            [("moe", cfg.n_layers - first)]
    return [("dense", cfg.n_layers)]


def _layer_plan(cfg) -> List[Tuple[str, int, Tuple[str, ...]]]:
    """Serving-state plan: per segment ``(kind, count, components)``;
    ``components`` names the decode-state objects every layer of the
    segment owns: "attn" (kv pages or the srf state, resolved by
    ``serving.paged_cache.attn_family_for``) and/or "ssm" (the ssd
    constant state). Hybrid layers own both."""
    comps = {"ssm": ("ssm",), "hybrid": ("attn", "ssm")}
    return [(kind, count, comps.get(kind, ("attn",)))
            for kind, count in segments(cfg)]


def init(cfg, seed: int = 0, device="cuda") -> Dict:
    """Random params from a seeded ``torch.Generator`` on ``device``
    (same shapes and laws as ``repro.models.transformer.init``; other
    numbers, since torch and jax draw differently)."""
    dt = dtype_of(cfg)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    d = cfg.d_model
    params: Dict = {"embed": layers.embed_init(gen, cfg.padded_vocab, d, dt,
                                               device)}
    params["segments"] = [layer_init(gen, cfg, kind, dt, device, (count,))
                          for kind, count in segments(cfg)]
    params["final_norm"] = layers.rmsnorm_init(d, dt, device)
    if not cfg.tie_embeddings:
        params["head"] = layers.dense_init(gen, d, cfg.padded_vocab, dt,
                                           device)
    return params


def layer_init(gen: torch.Generator, cfg, kind: str, dtype, device=None,
               lead=()) -> Dict:
    """One layer's params of ``kind``; ``lead`` stacks a layer axis."""
    d = cfg.d_model
    p: Dict = {"ln1": layers.rmsnorm_init(d, dtype, device, lead)}
    if kind == "ssm":
        p["ssm"] = ssm.ssm_init(gen, cfg, dtype, device, lead)
        return p
    p["attn"] = attention.attn_init(gen, cfg, dtype, device, lead)
    if kind == "hybrid":
        p["ssm"] = ssm.ssm_init(gen, cfg, dtype, device, lead)
        p["fuse_na"] = layers.rmsnorm_init(d, dtype, device, lead)
        p["fuse_ns"] = layers.rmsnorm_init(d, dtype, device, lead)
    p["ln2"] = layers.rmsnorm_init(d, dtype, device, lead)
    if kind == "moe":
        p["moe"] = moe.moe_init(gen, cfg, dtype, device, lead)
    else:
        p["mlp"] = layers.mlp_init(gen, d, cfg.d_ff, dtype, device, lead)
    return p


def requires_grad(params) -> Dict:
    """Mark every float leaf of ``params`` as a trainable leaf (in place;
    integer leaves, the seeds of seeded SRF, stay untracked)."""
    for t in tree_lib.leaves(params):
        if t.is_floating_point():
            t.requires_grad_(True)
    return params


def tree_index(tree, i: int):
    """The i-th slice of every tensor leaf of a nested dict/tuple/list."""
    if isinstance(tree, dict):
        return {k: tree_index(v, i) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_index(v, i) for v in tree)
    return tree[i]


def layer_apply(p, cfg, kind: str, x: torch.Tensor, positions: torch.Tensor,
                mode: str = "train", cache: Optional[Dict] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One decoder layer (dense, ssm, hybrid or moe) -> (x, aux_loss:
    the moe layer's load-balance loss, else 0); in modes "prefill" and
    "decode" the layer's ``cache`` is written in place. A hybrid layer's
    attention and SSD halves share the pre-norm and are fused as 0.5
    (rmsnorm(a) + rmsnorm(s))."""
    if kind not in ("dense", "ssm", "hybrid", "moe"):
        raise NotImplementedError(f"{kind} layers are "
                                  f"{attention.NOT_IN_SLICE}")
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    h = layers.rmsnorm(p["ln1"], x, cfg.norm_eps)
    if kind == "ssm":
        return x + ssm.ssm_apply(p["ssm"], cfg, h, mode, cache), aux
    if kind == "hybrid":
        a = attention.attention(p["attn"], cfg, h, positions, mode,
                                None if cache is None else cache["attn"])
        s = ssm.ssm_apply(p["ssm"], cfg, h, mode,
                          None if cache is None else cache["ssm"])
        x = x + _fuse(p, cfg, a, s)
    else:
        x = x + attention.attention(p["attn"], cfg, h, positions, mode,
                                    cache)
    h2 = layers.rmsnorm(p["ln2"], x, cfg.norm_eps)
    if kind == "moe":
        y, aux = moe.moe_apply(p["moe"], cfg, h2)
    else:
        y = layers.mlp(p["mlp"], h2)
    return x + y, aux


def _fuse(p, cfg, a: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """A hybrid layer's fusion of its attention and SSD outputs."""
    return 0.5 * (layers.rmsnorm(p["fuse_na"], a, cfg.norm_eps)
                  + layers.rmsnorm(p["fuse_ns"], s, cfg.norm_eps))


def _cache_at(caches: Dict, i: int) -> Dict:
    """Layer i's view of a segment's stacked cache ("idx" is shared)."""
    return {k: _cache_at(v, i) if isinstance(v, dict)
            else v if k == "idx" else v[i] for k, v in caches.items()}


def _take_idx(caches: Dict, layer: Dict) -> None:
    """Carry a layer's advanced "idx" entries back to the segment's."""
    for k, v in layer.items():
        if isinstance(v, dict):
            _take_idx(caches[k], v)
        elif k == "idx":
            caches[k] = v


def _save_matmuls(ctx, op, *args, **kwargs):
    """Selective-checkpoint policy of ``remat="dots"``: keep the outputs
    of matrix products, recompute everything else."""
    policy = ckpt.CheckpointPolicy
    return policy.MUST_SAVE if op in (torch.ops.aten.mm.default,
                                      torch.ops.aten.bmm.default) \
        else policy.PREFER_RECOMPUTE


def _remat(cfg, fn):
    """``fn`` recomputed in the backward as ``cfg.remat`` says: "none"
    keeps every activation, "full" keeps only the inputs, "dots" keeps
    the matmul outputs (the reference's ``checkpoint_dots`` policy)."""
    if cfg.remat == "none":
        return fn
    kw = {}
    if cfg.remat == "dots":
        kw["context_fn"] = functools.partial(
            ckpt.create_selective_checkpoint_contexts, _save_matmuls)
    elif cfg.remat != "full":
        raise ValueError(f"remat {cfg.remat!r} not in none | dots | full")

    def run(*args):
        return ckpt.checkpoint(fn, *args, use_reentrant=False, **kw)
    return run


def run_segment(stacked, cfg, kind: str, x: torch.Tensor,
                positions: torch.Tensor, mode: str = "train",
                caches: Optional[Dict] = None
                ) -> Tuple[torch.Tensor, Optional[Dict], torch.Tensor]:
    """All layers of one segment -> (x, caches, aux_sum).

    Modes "prefill" and "decode" run the layers in order against the
    segment's ``caches`` (``init_serve_cache``), each layer on its slice
    of the stacked buffers, written in place; the returned caches are
    the same object, its "idx" advanced. Mode "train" returns None for
    the caches. In training, with ``cfg.scan_group`` g > 1 (dividing the layer count) the
    recompute nests as the reference's does: the outer checkpoint keeps
    the residual only every g layers, and the inner per-layer checkpoints
    recompute one layer's internals at a time. The reference's
    ``_barrier`` (an XLA scheduling device, the identity on values) has
    no counterpart: eager PyTorch runs the layers in program order."""
    count = tree_lib.leaves(stacked)[0].shape[0]
    if mode in ("prefill", "decode"):
        for i in range(count):
            lc = _cache_at(caches, i)
            x, _ = layer_apply(tree_index(stacked, i), cfg, kind, x,
                               positions, mode, lc)
        _take_idx(caches, lc)
        return x, caches, torch.zeros((), dtype=torch.float32,
                                      device=x.device)
    if mode != "train":
        raise NotImplementedError(f"run_segment mode {mode!r} is "
                                  f"{attention.NOT_IN_SLICE}")
    g = cfg.scan_group if (cfg.scan_group > 1
                           and count % cfg.scan_group == 0) else 1

    def one_layer(x, lp):
        return layer_apply(lp, cfg, kind, x, positions, mode)
    inner = _remat(cfg, one_layer) if g > 1 else one_layer

    def body(x, *group):
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        for lp in group:
            x, a = inner(x, lp)
            aux = aux + a
        return x, aux
    body = _remat(cfg, body)
    per_layer = tree_lib.unbind(stacked, count)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for i in range(0, count, g):
        x, a = body(x, *per_layer[i:i + g])
        aux = aux + a
    return x, None, aux


def embed_inputs(params, cfg, batch: Dict
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """-> (x, positions) for a text batch {"tokens", optional
    "positions"}; the vision and audio front ends are not ported."""
    if cfg.is_encdec or cfg.frontend != "none":
        raise NotImplementedError(f"{cfg.name} inputs are "
                                  f"{attention.NOT_IN_SLICE}")
    tokens = batch["tokens"]
    x = layers.embed(params["embed"], tokens).to(dtype_of(cfg))
    b, l = tokens.shape
    positions = batch.get("positions")
    if positions is None:
        positions = torch.arange(l, device=tokens.device)[None].expand(b, l)
    return hooks.constrain(x, "activation"), positions


def forward(params, cfg, batch: Dict) -> Tuple[torch.Tensor, torch.Tensor]:
    """Training forward -> (logits (B, L, V_padded), aux)."""
    x, positions = embed_inputs(params, cfg, batch)
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    for seg_params, (kind, _) in zip(params["segments"], segments(cfg)):
        x, _, aux = run_segment(seg_params, cfg, kind, x, positions)
        aux_total = aux_total + aux
    return _logits(params, cfg, x), aux_total


def loss_fn(params, cfg, batch: Dict, aux_weight: float = 0.01
            ) -> Tuple[torch.Tensor, Dict]:
    """-> (loss, {"xent", "aux"}); labels outside [0, vocab) are masked."""
    logits, aux = forward(params, cfg, batch)
    labels = batch["labels"]
    if logits.shape[1] != labels.shape[1]:      # vlm: vision prefix unlabeled
        logits = logits[:, -labels.shape[1]:]
    xent = layers.cross_entropy(logits, labels, cfg.vocab)
    return xent + aux_weight * aux, {"xent": xent, "aux": aux}


def _logits(params, cfg, x: torch.Tensor) -> torch.Tensor:
    x = layers.rmsnorm(params["final_norm"], x, cfg.norm_eps)
    w = params["embed"]["tok"].T if cfg.tie_embeddings else params["head"]
    return hooks.constrain(x @ w, "logits")


def init_serve_cache(cfg, batch_size: int, max_len: int,
                     device="cuda") -> Dict:
    """The legacy engine's cache for ``batch_size`` requests of up to
    ``max_len`` tokens: per segment, ``attention.init_cache`` (dense),
    ``ssm.init_ssm_cache`` (ssm) or both (hybrid: {"attn", "ssm"}) with
    a leading layer axis, in the params' dtype, on ``device``."""
    dt = dtype_of(cfg)

    def seg(kind, count):
        lead = (count,)
        c = {"attn": lambda: attention.init_cache(cfg, batch_size, max_len,
                                                  dt, device, lead=lead),
             "ssm": lambda: ssm.init_ssm_cache(cfg, batch_size, dt, device,
                                               lead=lead)}
        if kind == "hybrid":
            return {name: make() for name, make in c.items()}
        return c["ssm" if kind == "ssm" else "attn"]()
    return {"segments": [seg(kind, count) for kind, count in segments(cfg)],
            "pos": 0}


def prefill(params, cfg, batch: Dict, cache: Dict
            ) -> Tuple[torch.Tensor, Dict]:
    """The prompt ``batch["tokens"]`` (B, L) through every layer, the
    cache written in place -> (logits of the last position (B, 1,
    V_padded), cache)."""
    x, positions = embed_inputs(params, cfg, batch)
    for seg_params, seg_cache, (kind, _) in zip(
            params["segments"], cache["segments"], segments(cfg)):
        x, _, _ = run_segment(seg_params, cfg, kind, x, positions,
                              "prefill", seg_cache)
    cache["pos"] = x.shape[1]
    return _logits(params, cfg, x[:, -1:]), cache


def decode_step(params, cfg, cache: Dict, tokens: torch.Tensor
                ) -> Tuple[torch.Tensor, Dict]:
    """tokens (B, 1) at position ``cache["pos"]`` -> (logits (B, 1,
    V_padded), cache), the cache written in place."""
    pos = cache["pos"]
    positions = torch.full((tokens.shape[0], 1), pos, dtype=torch.int64,
                           device=tokens.device)
    x = hooks.constrain(layers.embed(params["embed"], tokens)
                        .to(dtype_of(cfg)), "activation")
    for seg_params, seg_cache, (kind, _) in zip(
            params["segments"], cache["segments"], segments(cfg)):
        x, _, _ = run_segment(seg_params, cfg, kind, x, positions,
                              "decode", seg_cache)
    cache["pos"] = pos + 1
    return _logits(params, cfg, x), cache


def paged_step(params, cfg, pools: Dict, tokens: torch.Tensor,
               positions: torch.Tensor, q_valid: torch.Tensor,
               tables: torch.Tensor, slots: torch.Tensor,
               embed_seeds: Optional[torch.Tensor] = None
               ) -> Tuple[torch.Tensor, Dict]:
    """One batched step against the pooled caches (serving hot path).

    tokens: (B, C) int — C = 1 for batched decode, C = prefill chunk for
    chunked prefill; positions: (B, C) absolute positions; q_valid:
    (B, C) validity; tables: (B, M) page ids into the paged-domain pools
    (full-KV attention; 0 = null page); slots: (B,) slot ids into the
    slot-domain pools (SRF attention; 0 = null slot for padded rows).
    ``pools`` is the container from ``serving.paged_cache.init_pools``
    ({"paged", "slot"} per-segment lists); each layer's pools are
    updated IN PLACE (full-KV pages in the paged domain; the SRF and
    SSD states in the slot domain: a hybrid layer carries a kv sub-pool
    and an ssd sub-pool side by side, or two slot sub-pools with SRF)
    and the same container is returned. Returns (logits (B, C,
    V_padded), pools).

    ``embed_seeds``: optional (B,) per-request projection seeds for
    seeded-SRF configs (0 = base projection; ignored by full attention).
    Every layer's seeds are folded with them once per step (one batched
    threefry, not one per layer), and each SRF layer's feature maps run
    on its folded seeds.
    """
    dt = dtype_of(cfg)
    x = hooks.constrain(layers.embed(params["embed"], tokens).to(dt),
                        "activation")
    for seg_params, pseg, sseg, (kind, count) in zip(
            params["segments"], pools["paged"], pools["slot"],
            segments(cfg)):
        folded = None
        if embed_seeds is not None and cfg.attn_impl == "srf" \
                and "attn" in seg_params:
            if not cfg.srf.seeded:
                raise ValueError("embed_seeds requires SRFConfig.seeded="
                                 "True")
            folded = srf.fold_embed(seg_params["attn"]["srf"], embed_seeds)
        for i in range(count):
            x = _paged_layer(tree_index(seg_params, i), cfg, kind, x,
                             positions, q_valid,
                             None if pseg is None else tree_index(pseg, i),
                             None if sseg is None else tree_index(sseg, i),
                             tables, slots,
                             None if folded is None
                             else tree_index(folded, i))
    return _logits(params, cfg, x), pools


def _paged_layer(p, cfg, kind: str, x: torch.Tensor, positions, q_valid,
                 lpaged, lslot, tables, slots,
                 srf_folded=None) -> torch.Tensor:
    """Single-layer paged step (``layer_apply`` for serving); the
    attention pool (``lslot["attn"]`` for SRF, ``lpaged["attn"]`` for
    full KV or MLA latents) and the SSD pool (``lslot["ssm"]``) are
    updated in place. ``srf_folded``: the layer's seeds folded with the
    step's embed seeds (seeded SRF). A moe layer routes with
    ``valid=q_valid``: padded chunk rows take no expert capacity."""
    h = layers.rmsnorm(p["ln1"], x, cfg.norm_eps)
    if kind == "ssm":
        return x + ssm.paged_ssm_step(p["ssm"], cfg, h, q_valid,
                                      lslot["ssm"], slots)
    attn_pools = lslot if cfg.attn_impl == "srf" else lpaged
    ctx = {"pool": attn_pools["attn"], "tables": tables, "slots": slots,
           "q_valid": q_valid}
    if srf_folded is not None:
        ctx["srf_folded"] = srf_folded
    a = attention.attention(p["attn"], cfg, h, positions, "paged", ctx)
    if kind == "hybrid":
        s = ssm.paged_ssm_step(p["ssm"], cfg, h, q_valid, lslot["ssm"],
                               slots)
        x = x + _fuse(p, cfg, a, s)
    else:
        x = x + a
    h2 = layers.rmsnorm(p["ln2"], x, cfg.norm_eps)
    if kind == "moe":
        return x + moe.moe_apply(p["moe"], cfg, h2, valid=q_valid)[0]
    return x + layers.mlp(p["mlp"], h2)
