"""hymba-1.5b [hybrid] — arXiv:2411.13676.
32L d_model=1600 25H (GQA kv=5, head_dim=64) d_ff=5504 vocab=32001,
ssm_state=16; parallel attention + mamba heads fused per layer.

Adaptation notes (DESIGN.md): Hymba's meta-tokens and sliding-window mix
are not modeled; the parallel attn||SSM heads with per-branch output norm
and mean fusion are."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="hymba-1.5b", family="hybrid",
    n_layers=32, d_model=1600, n_heads=25, n_kv_heads=5, head_dim=64,
    d_ff=5504, vocab=32001, ssm_state=16, ssm_expand=2, ssm_head_dim=64,
    max_seq=8192, dtype="bfloat16",
)
