"""Serving layer of the port.  Counterpart of ``src/repro/serving/``:
``engine``, ``kv_pool`` and ``locality`` are ported; ``scheduler``
(``BatchScheduler`` and the tenant types) comes with ``core/`` in the
scheduler/core slice."""
from .engine import ServeEngine, ServeStats, SuspendedRow
from .kv_pool import KVBlockPool, PoolExhausted
from .locality import plan_window_jobs, prefetch_candidates

__all__ = ["ServeEngine", "ServeStats", "SuspendedRow", "KVBlockPool",
           "PoolExhausted", "plan_window_jobs", "prefetch_candidates"]
