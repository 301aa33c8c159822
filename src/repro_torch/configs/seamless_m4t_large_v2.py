"""seamless-m4t-large-v2 [audio] — arXiv:2308.11596.
24L enc + 24L dec, d_model=1024 16H (kv=16, head_dim=64) d_ff=8192
vocab=256206. Audio frontend is a stub (precomputed frame embeddings) per
spec; positions use RoPE in place of the original learned/sinusoidal
(noted in DESIGN.md)."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-large-v2", family="audio",
    n_layers=24, enc_layers=24, enc_len=1024,
    d_model=1024, n_heads=16, n_kv_heads=16, head_dim=64,
    d_ff=8192, vocab=256206, frontend="audio_stub", max_seq=8192,
    dtype="bfloat16",
)
