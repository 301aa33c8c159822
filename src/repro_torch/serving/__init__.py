"""Paged continuous-batching serving over full-KV pages or SRF slots."""
from .blocks import BlockAllocator, BlockTable          # noqa: F401
from .engine import Engine, Request                     # noqa: F401
from .paged_cache import (PagedConfig, PoolPlan, init_pools,  # noqa: F401
                          plan_for)
from .prefix import ChunkConfig, PrefixCache, PrefixConfig  # noqa: F401
from .scheduler import SchedConfig, Scheduler           # noqa: F401
