"""The program under test, as the drivers take it: the port's model
configuration built from a configuration file's keys. The one module of
the harness, with the drivers, that imports ``repro_torch``."""
from __future__ import annotations

import dataclasses
from typing import Dict

from repro_torch.configs.base import ModelConfig, SRFAttnConfig

# published config.json keys -> the port's ModelConfig fields
KEYS = {"hidden_size": "d_model", "intermediate_size": "d_ff",
        "num_hidden_layers": "n_layers",
        "num_attention_heads": "n_heads",
        "num_key_value_heads": "n_kv_heads", "head_dim": "head_dim",
        "vocab_size": "vocab", "rope_theta": "rope_theta",
        "rms_norm_eps": "norm_eps",
        "max_position_embeddings": "max_seq",
        "tie_word_embeddings": "tie_embeddings",
        "attention_bias": "qkv_bias", "torch_dtype": "dtype"}


def model_config(config: Dict) -> ModelConfig:
    """The port's ModelConfig of a configuration file: its published
    keys through ``KEYS``, then its ``port`` object (the port's own
    fields: name, family, qk_norm, attn_impl, srf, remat)."""
    fields = {KEYS[k]: v for k, v in config.items() if k in KEYS}
    port = dict(config.get("port", {}))
    if "srf" in port:
        port["srf"] = SRFAttnConfig(**port["srf"])
    cfg = ModelConfig(**{**fields, **port})
    return dataclasses.replace(cfg, rope_theta=float(cfg.rope_theta),
                               norm_eps=float(cfg.norm_eps))
