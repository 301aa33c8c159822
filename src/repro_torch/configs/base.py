"""Model/config schema shared by all architectures.

Every assigned architecture gets one file in this package exporting
``CONFIG`` (full-size, exact public numbers) and ``reduced()`` (same
family, tiny dims, for CPU smoke tests). ``registry.py`` maps ids to both.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field, replace
from typing import Optional, Tuple


def _ceil_to(x: int, mult: int) -> int:
    return ((x + mult - 1) // mult) * mult


@dataclass(frozen=True)
class SRFAttnConfig:
    """Paper technique knobs for SRF (structured random-feature) attention."""
    kind: str = "circulant"         # structured class (budget-of-randomness knob)
    n_features: int = 256           # m
    feature: str = "softmax_pos"
    r: int = 1                      # displacement rank (ldr)
    chunk: int = 128                # causal chunk
    seeded: bool = False            # zero-storage projections regenerated
                                    # from one uint32 seed per head; unlocks
                                    # per-request embed_seed personalization


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                     # dense | moe | ssm | hybrid | encdec | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 128
    max_seq: int = 131072

    # attention
    attn_impl: str = "full"         # full | srf   (srf = the paper's mechanism)
    qkv_bias: bool = False
    qk_norm: bool = False
    rope_theta: float = 10000.0
    m_rope: bool = False            # qwen2-vl M-RoPE
    m_rope_sections: Tuple[int, ...] = (16, 24, 24)
    srf: SRFAttnConfig = field(default_factory=SRFAttnConfig)

    # MoE
    moe_experts: int = 0
    moe_top_k: int = 0
    moe_shared: int = 0             # shared experts (deepseek style)
    moe_d_ff: int = 0               # per-expert hidden
    moe_first_dense: int = 0        # leading dense layers
    moe_capacity_factor: float = 1.25

    # MLA (deepseek latent attention)
    mla_kv_lora: int = 0            # 0 = plain GQA
    mla_qk_nope: int = 128
    mla_qk_rope: int = 64
    mla_v_dim: int = 128

    # SSM (mamba2 / hybrid)
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_conv: int = 4
    ssm_chunk: int = 256

    # serving
    kv_cache_dtype: str = "bf16"    # bf16 | int8 (quantized KV cache:
                                    # per-token-per-head scales; halves
                                    # decode cache bytes)

    # enc-dec
    enc_layers: int = 0             # >0 => encoder-decoder
    enc_len: int = 1024             # encoder memory length for shapes

    # frontends ([audio]/[vlm] are stubs per spec)
    frontend: str = "none"          # none | audio_stub | vision_stub
    n_vision_tokens: int = 1024

    # numerics / training
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    dtype: str = "float32"          # params+activations; reductions f32
    remat: str = "full"             # none | dots | full
    scan_group: int = 1             # layers per checkpointed scan step:
                                    # residuals saved every k layers (k x
                                    # less saved-stack memory, same FLOPs
                                    # under full remat)

    @property
    def padded_vocab(self) -> int:
        """Vocab padded for even sharding (standard practice; loss masks pad)."""
        return _ceil_to(self.vocab, 256)

    @property
    def q_dim(self) -> int:
        return self.n_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.n_kv_heads * self.head_dim

    @property
    def d_inner(self) -> int:       # ssm inner width
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    @property
    def is_moe(self) -> bool:
        return self.moe_experts > 0

    @property
    def is_mla(self) -> bool:
        return self.mla_kv_lora > 0

    @property
    def is_encdec(self) -> bool:
        return self.enc_layers > 0

    @property
    def mla_qk_dim(self) -> int:
        return self.mla_qk_nope + self.mla_qk_rope

    def param_count(self) -> int:
        """Analytic parameter count (embedding included once)."""
        d, v = self.d_model, self.padded_vocab
        n = 0
        n += v * d                                  # embed
        if not self.tie_embeddings:
            n += v * d                              # lm head
        def attn_params():
            if self.is_mla:
                a = d * self.mla_kv_lora + d * self.mla_qk_rope
                a += self.mla_kv_lora * self.n_heads * (self.mla_qk_nope + self.mla_v_dim)
                a += d * self.n_heads * self.mla_qk_dim
                a += self.n_heads * self.mla_v_dim * d
                return a
            a = d * self.q_dim + 2 * d * self.kv_dim + self.q_dim * d
            if self.qkv_bias:
                a += self.q_dim + 2 * self.kv_dim
            return a
        def mlp_params(ff):
            return 3 * d * ff
        def ssm_params():
            di, ns, nh = self.d_inner, self.ssm_state, self.ssm_heads
            conv_dim = di + 2 * ns
            a = d * (2 * di + 2 * ns + nh)          # in_proj
            a += conv_dim * self.ssm_conv           # conv
            a += 2 * nh + di                        # A_log, D, norm
            a += di * d                             # out_proj
            return a
        for layer in range(self.n_layers):
            n += 2 * d                              # norms
            if self.family == "ssm":
                n += ssm_params()
                continue
            if self.family == "hybrid":
                n += attn_params() + ssm_params()
            else:
                n += attn_params()
            if self.is_moe and layer >= self.moe_first_dense:
                n += d * self.moe_experts           # router
                n += self.moe_experts * mlp_params(self.moe_d_ff) // 1
                n += mlp_params(self.moe_shared * self.moe_d_ff)
            else:
                n += mlp_params(self.d_ff)
        if self.is_encdec:
            # encoder layers + cross attention in decoder
            for _ in range(self.enc_layers):
                n += 2 * d + attn_params() + mlp_params(self.d_ff)
            n += self.n_layers * (d + attn_params())   # cross attn + norm
        return n

    def active_param_count(self) -> int:
        """Params touched per token (MoE: top_k+shared experts only)."""
        if not self.is_moe:
            return self.param_count()
        full = self.param_count()
        moe_layers = self.n_layers - self.moe_first_dense
        unused = (self.moe_experts - self.moe_top_k) * 3 * self.d_model * self.moe_d_ff
        return full - moe_layers * unused
