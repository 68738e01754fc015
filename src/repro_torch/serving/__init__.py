"""Serving layer of the port.  Counterpart of ``src/repro/serving/``:
``engine``, ``kv_pool``, ``locality`` and ``scheduler`` (copied from the
reference; only its imports point at the port)."""
from .engine import ServeEngine, ServeStats, SuspendedRow
from .kv_pool import KVBlockPool, PoolExhausted
from .locality import plan_window_jobs, prefetch_candidates
from .scheduler import (BatchScheduler, PrefixFill, Request, RoundFuture,
                        TenantBudgetExceeded, TenantSpec, TenantStats)

__all__ = ["ServeEngine", "ServeStats", "SuspendedRow", "KVBlockPool",
           "PoolExhausted", "BatchScheduler", "PrefixFill", "Request",
           "RoundFuture", "TenantSpec", "TenantStats", "TenantBudgetExceeded",
           "plan_window_jobs", "prefetch_candidates"]
