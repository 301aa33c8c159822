"""Paged continuous-batching serving over the SRF constant-state pools."""
from .blocks import BlockAllocator, BlockTable          # noqa: F401
from .engine import Engine, Request                     # noqa: F401
from .paged_cache import PoolPlan, plan_for               # noqa: F401
from .scheduler import SchedConfig, Scheduler           # noqa: F401
