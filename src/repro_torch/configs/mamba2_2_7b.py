"""mamba2-2.7b [ssm] — arXiv:2405.21060 (SSD / state-space duality).
64L d_model=2560 attention-free, d_ff=0, vocab=50280, ssm_state=128,
expand=2 (d_inner=5120), head_dim=64 -> 80 SSD heads."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-2.7b", family="ssm",
    n_layers=64, d_model=2560, n_heads=1, n_kv_heads=1, head_dim=64,
    d_ff=0, vocab=50280, ssm_state=128, ssm_expand=2, ssm_head_dim=64,
    max_seq=1048576, dtype="bfloat16",
)
