"""The program's own spans and counters (``repro_torch.trace``), which it
records only while a profiler records: in a traced run, the traced slice.

``summary()`` is None where the program has no tracer (a commit before it)
or recorded nothing; the readers in ``bench/metrics/`` then report nothing.
"""
from __future__ import annotations

from typing import Optional


def summary() -> Optional[dict]:
    try:
        from repro_torch import trace
    except ImportError:
        return None
    s = trace.summary()
    return s if s["spans"] or s["counters"] else None


def span_count(s: dict, name: str) -> int:
    return s["spans"].get(name, {}).get("count", 0)


def self_ms(s: dict, names) -> float:
    """Self host milliseconds of every span named in ``names``."""
    return sum(v["self_ns"] for k, v in s["spans"].items() if k in names) / 1e6
