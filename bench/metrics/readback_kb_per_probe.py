"""Kilobytes of logits copied to the host per live probe row over the
traced slice (the program's counters ``engine.readback_bytes``, padded rows
included, over ``engine.probe_rows``)."""
from bench.harness.program_trace import summary


def read(run: dict):
    s = summary()
    rows = s["counters"].get("engine.probe_rows", 0) if s else 0
    return s["counters"]["engine.readback_bytes"] / rows / 1000 if rows else None
