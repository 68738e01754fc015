"""Host milliseconds a tick spends in the operator layer, from the
program's own spans over the traced slice: the self time of
``operator.executor_tick`` and ``operator.driver_tick`` (less the program's
spans directly inside them, the scheduler's step; enqueueing a round counts
with the operator), over the slice's executor ticks.  The program-side twin
of ``operator_host_ms_per_tick``."""
from bench.harness.program_trace import self_ms, span_count, summary

TICK_SPANS = ("operator.executor_tick", "operator.driver_tick")


def read(run: dict):
    s = summary()
    ticks = span_count(s, "operator.executor_tick") if s else 0
    return self_ms(s, TICK_SPANS) / ticks if ticks else None
