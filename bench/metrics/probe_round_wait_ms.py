"""Milliseconds a probe round waits in the scheduler's queue, from its
submission to the first servicing of any of its members, over the rounds
of the traced slice (the program's counters ``scheduler.round_wait_ns`` and
``scheduler.rounds``)."""
from bench.harness.program_trace import summary


def read(run: dict):
    s = summary()
    rounds = s["counters"].get("scheduler.rounds", 0) if s else 0
    return s["counters"]["scheduler.round_wait_ns"] / rounds / 1e6 if rounds else None
