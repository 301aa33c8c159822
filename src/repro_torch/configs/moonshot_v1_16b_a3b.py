"""moonshot-v1-16b-a3b [moe] — hf:moonshotai/Moonlight-16B-A3B (kimi).
48L d_model=2048 16H (GQA kv=16, head_dim=128) per-expert d_ff=1408,
MoE 64e top-6 + 2 shared, vocab=163840. Assigned-spec numbers used
verbatim (layer count per the assignment sheet)."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="moonshot-v1-16b-a3b", family="moe",
    n_layers=48, d_model=2048, n_heads=16, n_kv_heads=16, head_dim=128,
    d_ff=11264, vocab=163840,
    moe_experts=64, moe_top_k=6, moe_shared=2, moe_d_ff=1408,
    moe_first_dense=1,
    max_seq=131072, dtype="bfloat16",
)
