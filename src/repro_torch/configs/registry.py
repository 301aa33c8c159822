"""Architecture registry: ``--arch <id>`` resolution + reduced smoke configs."""
from __future__ import annotations

import dataclasses
from typing import Dict, List

from .base import ModelConfig, SRFAttnConfig
from . import (deepseek_v2_lite_16b, hymba_1_5b, internlm2_20b, mamba2_2_7b,
               mistral_nemo_12b, moonshot_v1_16b_a3b, qwen2_5_14b, qwen2_vl_2b,
               qwen3_4b, seamless_m4t_large_v2)

_MODULES = {
    "mistral-nemo-12b": mistral_nemo_12b,
    "internlm2-20b": internlm2_20b,
    "qwen2.5-14b": qwen2_5_14b,
    "qwen3-4b": qwen3_4b,
    "hymba-1.5b": hymba_1_5b,
    "seamless-m4t-large-v2": seamless_m4t_large_v2,
    "mamba2-2.7b": mamba2_2_7b,
    "deepseek-v2-lite-16b": deepseek_v2_lite_16b,
    "moonshot-v1-16b-a3b": moonshot_v1_16b_a3b,
    "qwen2-vl-2b": qwen2_vl_2b,
}

ARCHS: List[str] = list(_MODULES)


def get(name: str, **overrides) -> ModelConfig:
    if name not in _MODULES:
        raise KeyError(f"unknown arch {name!r}; known: {ARCHS}")
    cfg = _MODULES[name].CONFIG
    return dataclasses.replace(cfg, **overrides) if overrides else cfg


def reduced(name: str, **overrides) -> ModelConfig:
    """Tiny same-family config for CPU smoke tests (spec: small layers/width,
    few experts, tiny embedding tables)."""
    cfg = get(name)
    kw = dict(
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=128, vocab=512, max_seq=256, dtype="float32", remat="none",
        srf=SRFAttnConfig(kind=cfg.srf.kind, n_features=32, chunk=16),
        n_vision_tokens=8, enc_len=16, ssm_chunk=16,
    )
    if cfg.is_moe:
        kw.update(moe_experts=8, moe_top_k=2, moe_shared=1, moe_d_ff=32,
                  moe_first_dense=1, n_layers=3)
    if cfg.is_mla:
        kw.update(mla_kv_lora=32, mla_qk_nope=16, mla_qk_rope=8, mla_v_dim=16)
    if cfg.family in ("ssm", "hybrid"):
        kw.update(ssm_state=16, ssm_expand=2, ssm_head_dim=16)
    if cfg.is_encdec:
        kw.update(enc_layers=2)
    if cfg.m_rope:
        kw.update(m_rope_sections=(2, 3, 3))   # sums to head_dim/2 = 8
    if cfg.d_ff == 0:
        kw.update(d_ff=0)
    kw.update(overrides)
    return dataclasses.replace(cfg, **kw)
