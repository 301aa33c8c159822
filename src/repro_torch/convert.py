"""Carry reference params into the port.

``params_from_jax`` takes the param pytree of ``repro.models.transformer``
— passed as numpy arrays (``jax.tree.map(np.asarray, params)``), so this
module never imports jax — and returns the port's params: the same
nested layout (embed, stacked ``segments``, ``final_norm``, ``head``,
and per-layer ``attn.srf`` generators and HD diagonals, or the uint32
``seed`` leaves of seeded SRF, shaped (layers, kv heads); an MoE
config's two segments, dense then moe, with the f32 router, the experts
and the "shared" experts) with every leaf a torch tensor; float leaves
take the config's dtype, the router excepted. Seeds become int64
tensors holding the same 32-bit values, the port's seed representation
(``kernels.seedgen``). Both
packages then compute the same function. ``opt_state_from_jax`` carries
the reference's AdamW state across the same way, so both packages can
train on from one optimizer state.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch import tree as tree_lib
from repro_torch.models import transformer as model_lib


def _leaf(a: Any, device, dtype: torch.dtype) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.kind == "f" or a.dtype.name == "bfloat16":
        # numpy has no bfloat16 of its own: go through f32 (exact)
        return torch.from_numpy(a.astype(np.float32)).to(device, dtype)
    if a.dtype == np.uint32:                # seeds: words held in int64
        return torch.from_numpy(a.astype(np.int64)).to(device)
    return torch.from_numpy(np.ascontiguousarray(a)).to(device)


def _tree(t, device, dtype):
    if isinstance(t, dict):     # an MoE router stays f32 (moe.moe_init)
        return {k: _tree(v, device, torch.float32 if k == "router"
                         else dtype) for k, v in t.items()}
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


def opt_state_from_jax(state, params, device="cuda"):
    """Reference AdamW state ``{"mu", "nu", "count"}`` (numpy leaves, as
    ``jax.tree.map(np.asarray, state)``) -> the port's, on ``device``:
    f32 moments shaped like the port's ``params``, an int32 count."""
    out = {k: _tree(state[k], device, torch.float32) for k in ("mu", "nu")}
    for key in ("mu", "nu"):
        for (path, got), want in zip(tree_lib.leaves_with_path(out[key]),
                                     tree_lib.leaves(params)):
            if got.shape != want.shape:
                raise ValueError(f"{key}/{path}: {tuple(got.shape)} != "
                                 f"param {tuple(want.shape)}")
    out["count"] = torch.tensor(np.array(state["count"]),
                                   dtype=torch.int32, device=device)
    return out
