"""Online LP query-serving subsystem (DESIGN.md §9).

A one-shot solve (a RunSpec without a ``serve`` section) builds a
network, solves every seed, and exits.  This package turns the same
engines into a long-lived query service:

* :class:`~repro_torch.serve.scheduler.MicroBatcher` — coalesces pending queries
  into one batched solve per tick (bounded queue = backpressure), with
  priority-class admission control and an optional pipelined mode where
  the next batch assembles while the engine solves the current one.
* :class:`~repro_torch.serve.cache.ColumnCache` /
  :class:`~repro_torch.serve.cache.ShardedColumnCache` — LRU of solved label
  columns (optionally split into independently-locked shards); repeat
  queries are cache hits, cold queries warm-start from cached nearby
  columns.
* :class:`~repro_torch.serve.engine.LPServeEngine` — the front-end: ranking via
  ``core/ranking.py``, incremental :class:`~repro_torch.core.GraphDelta` updates
  with stale-column warm restarts, and convergence-aware early exit
  inside batch solves.
"""
from repro_torch.serve.cache import (
    CacheStats,
    ColumnCache,
    NetworkState,
    ShardedColumnCache,
)
from repro_torch.serve.engine import LPServeEngine, ServeConfig
from repro_torch.serve.replay import play_zipf, replay_trace
from repro_torch.serve.scheduler import MicroBatcher, SchedulerStats
from repro_torch.serve.types import (
    DEFAULT_PRIORITY,
    PRIORITY_CLASSES,
    QueryResult,
    QuerySpec,
)

__all__ = [
    "CacheStats",
    "ColumnCache",
    "DEFAULT_PRIORITY",
    "LPServeEngine",
    "MicroBatcher",
    "NetworkState",
    "PRIORITY_CLASSES",
    "QueryResult",
    "QuerySpec",
    "SchedulerStats",
    "ServeConfig",
    "ShardedColumnCache",
    "play_zipf",
    "replay_trace",
]
