"""Paged continuous-batching serving over full-KV pages or SRF slots,
and the request router with fault-tolerant serving over engine replicas
(``serving/mesh``, ``serving/ft``; the chaos harness
``serving/chaos`` is imported on its own)."""
from .blocks import BlockAllocator, BlockTable          # noqa: F401
from .engine import Engine, Request                     # noqa: F401
from .ft import FTConfig, ReplicaWatchdog               # noqa: F401
from .mesh import Router, RouterConfig                  # noqa: F401
from .paged_cache import (PagedConfig, PoolPlan, init_pools,  # noqa: F401
                          plan_for)
from .prefix import ChunkConfig, PrefixCache, PrefixConfig  # noqa: F401
from .scheduler import SchedConfig, Scheduler           # noqa: F401
