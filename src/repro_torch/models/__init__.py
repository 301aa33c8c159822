"""The model of every family: one config-driven implementation (dense,
SSD, hybrid, MoE, MLA, vision and enc-dec)."""
from . import attention, frontends, hooks, layers, moe, ssm, transformer

__all__ = ["attention", "frontends", "hooks", "layers", "moe", "ssm",
           "transformer"]
