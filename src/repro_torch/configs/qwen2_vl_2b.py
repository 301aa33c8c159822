"""qwen2-vl-2b [vlm] — arXiv:2409.12191.
28L d_model=1536 12H (GQA kv=2, head_dim=128) d_ff=8960 vocab=151936,
M-RoPE (sections 16/24/24), dynamic-resolution vision frontend stubbed
with precomputed patch embeddings."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-vl-2b", family="vlm",
    n_layers=28, d_model=1536, n_heads=12, n_kv_heads=2, head_dim=128,
    d_ff=8960, vocab=151936, m_rope=True, m_rope_sections=(16, 24, 24),
    frontend="vision_stub", n_vision_tokens=1024, rope_theta=1_000_000.0,
    max_seq=32768, dtype="bfloat16",
)
