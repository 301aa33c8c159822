"""Carry reference params into the port.

``params_from_jax`` takes the param pytree of ``repro.models.transformer``
— passed as numpy arrays (``jax.tree.map(np.asarray, params)``), so this
module never imports jax — and returns the port's params: the same
nested layout (embed, stacked ``segments``, ``final_norm``, ``head``,
and per-layer ``attn.srf`` generators and HD diagonals) with every leaf
a torch tensor. Both packages then compute the same function.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch.models import transformer as model_lib


def _leaf(a: Any, device, dtype: torch.dtype) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.kind == "f" or a.dtype.name == "bfloat16":
        # numpy has no bfloat16 of its own: go through f32 (exact)
        return torch.from_numpy(a.astype(np.float32)).to(device, dtype)
    return torch.from_numpy(np.ascontiguousarray(a)).to(device)


def _tree(t, device, dtype):
    if isinstance(t, dict):
        return {k: _tree(v, device, dtype) for k, v in t.items()}
    if isinstance(t, (tuple, list)):
        return type(t)(_tree(v, device, dtype) for v in t)
    return _leaf(t, device, dtype)


def params_from_jax(tree, cfg, device="cuda"):
    """Reference param pytree (numpy leaves) -> port params on ``device``,
    float leaves in ``cfg.dtype``. Checks the layout against ``cfg``."""
    want = {"embed", "segments", "final_norm"} | \
        (set() if cfg.tie_embeddings else {"head"})
    if set(tree) != want:
        raise ValueError(f"expected top-level keys {sorted(want)}, got "
                         f"{sorted(tree)}")
    segs = model_lib.segments(cfg)
    if len(tree["segments"]) != len(segs):
        raise ValueError(f"expected {len(segs)} segments, got "
                         f"{len(tree['segments'])}")
    for seg, (_, count) in zip(tree["segments"], segs):
        n = np.asarray(seg["ln1"]["w"]).shape[0]
        if n != count:
            raise ValueError(f"segment holds {n} layers, config says "
                             f"{count}")
    emb = np.asarray(tree["embed"]["tok"]).shape
    if emb != (cfg.padded_vocab, cfg.d_model):
        raise ValueError(f"embed is {emb}, config needs "
                         f"{(cfg.padded_vocab, cfg.d_model)}")
    return _tree(tree, device, model_lib.dtype_of(cfg))
