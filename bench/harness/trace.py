"""Reading a ``torch.profiler`` trace of a slice of the window.

The slice is marked by a ``bench.trace_slice`` range, on the trace's own
clock.  Device work is every event the trace holds on the card other than
the copies of the benchmark's own ranges; busy time is the union of their
intervals inside the slice (a sum of kernel times would count overlapping
kernels twice).  Each idle gap is named by the innermost benchmark span
(``operator.*``, ``scheduler.*``, ``engine.*``) open on the host at its
midpoint, ``host`` where none is.
"""
from __future__ import annotations

import bisect
from collections import defaultdict

SLICE = "bench.trace_slice"
SPAN_LAYERS = ("operator", "scheduler", "engine", "bench")


def _interval(e) -> tuple:
    if hasattr(e, "start_ns"):
        t0 = e.start_ns()
        return t0, t0 + e.duration_ns()
    t0 = e.start_us() * 1000
    return t0, t0 + e.duration_us() * 1000


def _is_span(name: str) -> bool:
    return name.split(".", 1)[0] in SPAN_LAYERS and "." in name


def read(prof) -> dict:
    """``window_s``, ``busy_s``, ``ops`` (device seconds by operation name)
    and ``gaps`` (idle seconds by the host span open)."""
    spans, dev = [], []
    window = None
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        t0, t1 = _interval(e)
        if "CUDA" in str(e.device_type()):
            if not _is_span(name):
                dev.append((t0, t1, name))
        elif name == SLICE:
            window = (t0, t1)
        elif _is_span(name):
            spans.append((t0, t1, name))
    if window is None:
        raise RuntimeError("the trace holds no slice marker")
    w0, w1 = window
    ops: dict = defaultdict(float)
    intervals = []
    for t0, t1, name in dev:
        a, b = max(t0, w0), min(t1, w1)
        if b > a:
            ops[name] += (b - a) / 1e9
            intervals.append((a, b))
    intervals.sort()
    busy = 0
    gaps = []
    cur = w0
    for a, b in intervals:
        if a > cur:
            gaps.append((cur, a))
        if b > cur:
            busy += b - max(a, cur)
            cur = b
    if cur < w1:
        gaps.append((cur, w1))
    # host spans nest (one thread): the last span started before a gap's
    # midpoint that is still open then is the innermost one
    spans.sort()
    starts = [s[0] for s in spans]
    named: dict = defaultdict(float)
    for a, b in gaps:
        mid = (a + b) / 2
        inner = "host"
        i = bisect.bisect_right(starts, mid) - 1
        while i >= 0:
            if spans[i][1] >= mid:
                inner = spans[i][2]
                break
            i -= 1
        named[inner] += (b - a) / 1e9
    return {"window_s": (w1 - w0) / 1e9, "busy_s": busy / 1e9,
            "ops": dict(ops), "gaps": dict(named)}


def top(d: dict, n: int = 10) -> list:
    return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:n]]
