"""Prefix regions a fill forward prefilled in the traced slice, whatever
their lengths (the program's counters ``engine.fill_regions`` over
``engine.fill_forwards``)."""
from bench.harness.program_trace import summary


def read(run: dict):
    s = summary()
    forwards = s["counters"].get("engine.fill_forwards", 0) if s else 0
    return s["counters"].get("engine.fill_regions", 0) / forwards if forwards else None
