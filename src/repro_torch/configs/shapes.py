"""Assigned input shapes and meta-device ``input_specs`` per cell.
Port of ``repro.configs.shapes``.

Four shapes per arch (40 cells):
    train_4k      seq 4096   batch 256   -> train_step
    prefill_32k   seq 32768  batch 32    -> prefill (inference)
    decode_32k    seq 32768  batch 128   -> serve_step (1 token, 32k cache)
    long_500k     seq 524288 batch 1     -> serve_step (sub-quadratic only)

``long_500k`` policy: SSM/hybrid archs run natively (O(1)-in-L state);
pure-attention archs run with the paper's SRF attention enabled (O(m d)
state replaces the 2.7TB KV cache). The exact-attention variant of those
cells is marked skipped(quadratic).

The specs are tensors on the ``meta`` device: shapes and dtypes with no
storage, which a step runs on for its shapes, flops and bytes
(``launch.cost_analysis``); a dtype is the reference's
``ShapeDtypeStruct``'s.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Dict, Tuple

import torch

from repro_torch.models import frontends, transformer
from .base import ModelConfig
from . import registry


@dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    step: str          # train | prefill | decode


SHAPES: Dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524288, 1, "decode"),
}


def cell_config(arch: str, shape: str, use_reduced: bool = False,
                **overrides) -> Tuple[ModelConfig, str]:
    """Resolve the (possibly technique-adapted) config for one cell.

    Returns (cfg, note); note records when the paper's SRF attention was
    switched on to make the cell feasible."""
    cfg = registry.reduced(arch) if use_reduced else registry.get(arch)
    note = ""
    if shape == "decode_32k" and cfg.attn_impl == "full" and not cfg.is_mla:
        # int8 KV cache for the decode shape: halves cache bytes; the
        # reference needs it for the 16-head MHA archs to fit its 16 GiB
        # chip, and the port keeps the reference's cells.
        cfg = dataclasses.replace(cfg, kv_cache_dtype="int8")
        note = "int8 KV cache"
    if shape == "long_500k" and cfg.family != "ssm":
        if cfg.family == "hybrid":
            cfg = dataclasses.replace(cfg, attn_impl="srf")
            note = "hybrid: SSM native + attention heads in SRF mode"
        else:
            cfg = dataclasses.replace(cfg, attn_impl="srf")
            note = ("exact attention infeasible at 524k (KV cache O(L)); "
                    "running the paper's SRF attention (O(m d) state)")
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    return cfg, note


def _i32(shape) -> torch.Tensor:
    return torch.empty(shape, dtype=torch.int32, device="meta")


def _f32(shape) -> torch.Tensor:
    return torch.empty(shape, dtype=torch.float32, device="meta")


def batch_specs(cfg: ModelConfig, b: int, l: int, training: bool) -> Dict:
    """Meta tensors of the data batch of a forward/train call."""
    specs: Dict = {}
    if cfg.is_encdec:
        specs["enc_emb"] = _f32((b, cfg.enc_len, frontends.AUDIO_FEAT_DIM))
        specs["tokens"] = _i32((b, l))
    elif cfg.frontend == "vision_stub":
        nv = min(cfg.n_vision_tokens, l // 2)
        specs["vision_emb"] = _f32((b, nv, frontends.VISION_FEAT_DIM))
        specs["tokens"] = _i32((b, l - nv))
        specs["pos3"] = _i32((3, b, l))
    else:
        specs["tokens"] = _i32((b, l))
    if training:
        specs["labels"] = _i32(specs["tokens"].shape)
    return specs


def cache_specs(cfg: ModelConfig, b: int, max_len: int) -> Dict:
    """The legacy serve cache (``transformer.init_serve_cache``) on meta;
    its "idx" and "pos" entries are host ints."""
    return transformer.init_serve_cache(cfg, b, max_len, device="meta")


def input_specs(cfg: ModelConfig, shape: str,
                batch_override: int = 0, seq_override: int = 0) -> Dict:
    """All model inputs (minus params) for the cell's step function."""
    ss = SHAPES[shape]
    b = batch_override or ss.global_batch
    l = seq_override or ss.seq_len
    if ss.step == "train":
        return {"batch": batch_specs(cfg, b, l, training=True)}
    if ss.step == "prefill":
        return {"batch": batch_specs(cfg, b, l, training=False),
                "cache": cache_specs(cfg, b, l)}
    if ss.step == "decode":
        return {"tokens": _i32((b, 1)), "cache": cache_specs(cfg, b, l)}
    raise ValueError(ss.step)
