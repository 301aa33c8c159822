"""Modality front ends of the audio and vision configs: stubs, as in
the reference. Port of ``repro.models.frontends``.

A request or batch carries precomputed frame (audio) or patch (vision)
features; the one learned piece is a linear adapter into d_model, so
the backbone sees a projected stream. ``synthetic_audio_features`` is
the reference's draw, the same numpy call, so both packages see the
same bytes from the same generator.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from . import layers

# feature widths of the precomputed stub embeddings
AUDIO_FEAT_DIM = 160     # fbank-like frame features
VISION_FEAT_DIM = 1176   # 14 x 14 x 2 x 3, qwen2-vl's patchify


def synthetic_audio_features(rng: np.random.Generator, cfg) -> np.ndarray:
    """One request's synthetic (enc_len, AUDIO_FEAT_DIM) frames from
    ``rng``, float32."""
    return (rng.standard_normal((cfg.enc_len, AUDIO_FEAT_DIM))
            * 0.2).astype(np.float32)


def feat_dim(cfg) -> int:
    """Width of the config's front-end features."""
    return {"audio_stub": AUDIO_FEAT_DIM,
            "vision_stub": VISION_FEAT_DIM}[cfg.frontend]


def frontend_init(gen: torch.Generator, cfg, dtype, device=None) -> Dict:
    """{"adapter": (feat_dim, d_model)}, or {} for a text-only config."""
    if cfg.frontend == "none":
        return {}
    return {"adapter": layers.dense_init(gen, feat_dim(cfg), cfg.d_model,
                                         dtype, device)}


def frontend_apply(p, cfg, feats: torch.Tensor) -> torch.Tensor:
    """(B, T, feat_dim) features -> (B, T, d_model) in the promoted
    dtype of the two (f32 features through a bf16 adapter: an f32
    product, as jax promotes; the caller casts to the model's dtype)."""
    w = p["adapter"]
    dt = torch.promote_types(feats.dtype, w.dtype)
    return feats.to(dt) @ w.to(dt)
