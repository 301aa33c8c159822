"""Dense decoder LM for the paged SRF serving path.

Port of the serving half of ``repro.models.transformer`` for the dense
family: ``init``, ``paged_step``, ``_paged_layer`` and ``_logits`` as
functions over a param dict. The param tree has the reference's layout,
so ``repro_torch.convert.params_from_jax`` maps one onto the other leaf
for leaf:

    {"embed": {"tok": (V, d)},
     "segments": [{"ln1": {"w"}, "attn": {...}, "ln2": {"w"},
                   "mlp": {"wi", "wg", "wo"}}],      # leading layer axis L
     "final_norm": {"w": (d,)},
     "head": (d, V)}                                  # absent when tied

Layers run as a Python loop over the stacked layer axis (the reference
scans). Other families (MoE, MLA, SSM, hybrid, enc-dec, vision) are not
ported in this slice and raise NotImplementedError.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import torch

from . import attention, hooks, layers


def dtype_of(cfg) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def segments(cfg) -> List[Tuple[str, int]]:
    """[(layer_kind, count)] for the decoder stack (dense only)."""
    if (cfg.family != "dense" or cfg.is_moe or cfg.is_mla
            or cfg.is_encdec or cfg.frontend != "none"):
        raise NotImplementedError(
            f"{cfg.name} ({cfg.family}) is {attention.NOT_IN_SLICE}")
    return [("dense", cfg.n_layers)]


def _layer_plan(cfg):
    """Serving-state plan: per segment ``(kind, count, components)``."""
    return [(kind, count, ("attn",)) for kind, count in segments(cfg)]


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
    params["segments"] = []
    for _, count in segments(cfg):
        lead = (count,)
        params["segments"].append({
            "ln1": layers.rmsnorm_init(d, dt, device, lead),
            "attn": attention.attn_init(gen, cfg, dt, device, lead),
            "ln2": layers.rmsnorm_init(d, dt, device, lead),
            "mlp": layers.mlp_init(gen, d, cfg.d_ff, dt, device, lead)})
    params["final_norm"] = layers.rmsnorm_init(d, dt, device)
    if not cfg.tie_embeddings:
        params["head"] = layers.dense_init(gen, d, cfg.padded_vocab, dt,
                                           device)
    return params


def tree_index(tree, i: int):
    """The i-th slice of every tensor leaf of a nested dict/tuple/list."""
    if isinstance(tree, dict):
        return {k: tree_index(v, i) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_index(v, i) for v in tree)
    return tree[i]


def _logits(params, cfg, x: torch.Tensor) -> torch.Tensor:
    x = layers.rmsnorm(params["final_norm"], x, cfg.norm_eps)
    w = params["embed"]["tok"].T if cfg.tie_embeddings else params["head"]
    return hooks.constrain(x @ w, "logits")


def paged_step(params, cfg, pools: Dict, tokens: torch.Tensor,
               positions: torch.Tensor, q_valid: torch.Tensor,
               tables: torch.Tensor, slots: torch.Tensor
               ) -> Tuple[torch.Tensor, Dict]:
    """One batched step against the pooled SRF states (serving hot path).

    tokens: (B, C) int — C = 1 for batched decode, C = prefill chunk for
    chunked prefill; positions: (B, C) absolute positions; q_valid:
    (B, C) validity; tables: (B, M) page ids (unused by the constant-state
    SRF family, kept for the reference's signature); slots: (B,) slot
    ids into the slot-domain pools (0 = null slot for padded rows).
    ``pools`` is the container from ``serving.paged_cache.init_pools``;
    its slot pools are updated IN PLACE and the same container is
    returned. Returns (logits (B, C, V_padded), pools).
    """
    dt = dtype_of(cfg)
    x = hooks.constrain(layers.embed(params["embed"], tokens).to(dt),
                        "activation")
    for seg_params, sseg, (kind, count) in zip(
            params["segments"], pools["slot"], segments(cfg)):
        for i in range(count):
            x = _paged_layer(tree_index(seg_params, i), cfg, kind, x,
                             positions, q_valid, tree_index(sseg, i),
                             tables, slots)
    return _logits(params, cfg, x), pools


def _paged_layer(p, cfg, kind: str, x: torch.Tensor, positions, q_valid,
                 lslot, tables, slots) -> torch.Tensor:
    """Single-layer paged step; ``lslot["attn"]`` is updated in place."""
    h = layers.rmsnorm(p["ln1"], x, cfg.norm_eps)
    ctx = {"pool": lslot["attn"], "tables": tables, "slots": slots,
           "q_valid": q_valid}
    x = x + attention.attention(p["attn"], cfg, h, positions, "paged", ctx)
    return x + layers.mlp(p["mlp"], layers.rmsnorm(p["ln2"], x,
                                                    cfg.norm_eps))
