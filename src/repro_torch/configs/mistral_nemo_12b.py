"""mistral-nemo-12b [dense] — hf:mistralai/Mistral-Nemo-Base-2407.
40L d_model=5120 32H (GQA kv=8, head_dim=128) d_ff=14336 vocab=131072, 128k ctx."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="mistral-nemo-12b", family="dense",
    n_layers=40, d_model=5120, n_heads=32, n_kv_heads=8, head_dim=128,
    d_ff=14336, vocab=131072, rope_theta=1_000_000.0, max_seq=131072,
    dtype="bfloat16",
)
