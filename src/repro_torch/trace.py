"""Spans and counters inside the probe path, recorded only while a
``torch.profiler`` session records.

It has no counterpart under ``src/repro/``: the reference has no spans
inside the program.

``span(name)`` is a context manager.  While a profiler records
(``torch.autograd._profiler_enabled()``, one C call) it opens a
``torch.profiler.record_function`` range of the same name, so every span is
a range of the profiler's trace, on that trace's clock, and it adds to
totals kept in memory by name: count, host ns, and self host ns (less the
host ns of the spans directly inside it).  Otherwise it returns one shared
no-op context: no allocation, no clock read, no range.  ``count(name, n)``
adds to a counter under the same condition.  ``summary()`` returns the
totals and counters; ``reset()`` clears them.  There is no exporter: the
profiler's own trace holds the ranges.

Names start with their layer: ``operator.``, ``scheduler.`` or
``engine.``.  A reader of the device trace must leave those names out of
device work, since the device-side copy of a range spans the kernels the
range launched.
"""
from __future__ import annotations

import contextlib
import functools
import time

import torch

recording = torch.autograd._profiler_enabled

_NOOP = contextlib.nullcontext()
_spans: dict[str, list] = {}          # name -> [count, total ns, self ns]
_counters: dict[str, int] = {}
_stack: list = []                     # the open spans, innermost last


class _Span:
    __slots__ = ("name", "range", "t0", "inner")

    def __init__(self, name: str):
        self.name = name

    # the clock is read just before the range opens and just before it
    # closes: the profiler stamps a range early in each of the two calls, so
    # the host totals and the trace's ranges measure the same intervals
    def __enter__(self):
        self.inner = 0
        _stack.append(self)
        self.range = torch.profiler.record_function(self.name)
        self.t0 = time.perf_counter_ns()
        self.range.__enter__()
        return self

    def __exit__(self, *exc):
        dt = time.perf_counter_ns() - self.t0
        self.range.__exit__(*exc)
        _stack.pop()
        if _stack:
            _stack[-1].inner += dt
        tot = _spans.setdefault(self.name, [0, 0, 0])
        tot[0] += 1
        tot[1] += dt
        tot[2] += dt - self.inner
        return False


def span(name: str):
    """A host span of ``name`` while a profiler records, else a no-op."""
    return _Span(name) if recording() else _NOOP


def spanned(name: str):
    """Decorate a function so that each call is one ``span(name)``."""
    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)
        return call
    return wrap


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name`` while a profiler records."""
    if recording():
        _counters[name] = _counters.get(name, 0) + n


def summary() -> dict:
    """``{"spans": {name: {"count", "total_ns", "self_ns"}},
    "counters": {name: n}}`` of everything recorded since ``reset``."""
    return {"spans": {k: dict(zip(("count", "total_ns", "self_ns"), v))
                      for k, v in _spans.items()},
            "counters": dict(_counters)}


def reset() -> None:
    _spans.clear()
    _counters.clear()
    _stack.clear()
