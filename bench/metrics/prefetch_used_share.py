"""Share of the prefix regions that the executor's prefetch filled in the
traced slice that a probe submission then looked up (the program's
counters ``engine.prefetch_used`` over ``engine.prefetch_filled``)."""
from bench.harness.program_trace import summary


def read(run: dict):
    s = summary()
    filled = s["counters"].get("engine.prefetch_filled", 0) if s else 0
    return 100.0 * s["counters"].get("engine.prefetch_used", 0) / filled if filled else None
