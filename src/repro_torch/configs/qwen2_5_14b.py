"""qwen2.5-14b [dense] — hf:Qwen/Qwen2.5 family.
48L d_model=5120 40H (GQA kv=8, head_dim=128) d_ff=13824 vocab=152064, QKV bias."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2.5-14b", family="dense",
    n_layers=48, d_model=5120, n_heads=40, n_kv_heads=8, head_dim=128,
    d_ff=13824, vocab=152064, qkv_bias=True, rope_theta=1_000_000.0,
    max_seq=131072, dtype="bfloat16",
)
