"""deepseek-v2-lite-16b [moe] — arXiv:2405.04434.
27L d_model=2048 16H MLA (kv_lora=512, qk 128+64 rope, v=128),
per-expert d_ff=1408, 2 shared + 64 routed experts top-6, first layer
dense (d_ff=10944), vocab=102400."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-v2-lite-16b", family="moe",
    n_layers=27, d_model=2048, n_heads=16, n_kv_heads=16, head_dim=128,
    d_ff=10944, vocab=102400,
    moe_experts=64, moe_top_k=6, moe_shared=2, moe_d_ff=1408,
    moe_first_dense=1,
    mla_kv_lora=512, mla_qk_nope=128, mla_qk_rope=64, mla_v_dim=128,
    max_seq=163840, dtype="bfloat16",
)
