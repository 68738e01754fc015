"""External bubble sort — the RankGPT sliding-window strategy (Sec. 3.2).

A window of ``m`` keys is ranked listwise, then the window slides by
``h = m/2`` toward the front of the output, so the best remaining ``h`` keys
"bubble up" per pass.  Pass ``p`` fixes output positions ``[0, p*h)``; with
LIMIT K only ``ceil(K/h)`` passes are needed — O(K*N/m^2) calls vs
O(N^2/m^2) for the full sort (Table 1).

Probe plan: windows within one pass form a strict dependency chain (each
overlaps its predecessor by ``m - h``), but windows of *successive passes*
are independent once the region they read has been fully written by the
previous pass.  The plan therefore software-pipelines the passes: the full
schedule of window ops is known statically, and each round greedily takes
every op whose earlier overlapping ops have all completed — a
dependency-preserving reorder, so every window call sees exactly the input
it would see sequentially and output order is byte-identical for any
deterministic-per-prompt oracle.  In steady state a round carries one window
from each in-flight pass (a wavefront), and each round suspends the plan as
ONE ``RankWindows`` probe set — cutting serving submissions from
``passes * windows_per_pass`` to ``~windows_per_pass + 2 * passes``.

Counterpart of ``src/repro/core/access_paths/bubble.py`` (copied; only imports and
cross-references point at the port)."""
from __future__ import annotations

import bisect
import math
from typing import Optional, Sequence

from ..executor import RankWindows
from ..types import Key, SortSpec
from .base import AccessPath, PathParams, register


def _pass_starts(n: int, m: int, h: int, fixed: int) -> list[int]:
    starts = []
    i = n - m
    while i > fixed:
        starts.append(i)
        i -= h
    starts.append(fixed)
    return starts


@register("ext_bubble")
class ExternalBubbleSort(AccessPath):
    def _plan(self, keys: Sequence[Key], spec: SortSpec):
        keys = list(keys)
        n = len(keys)
        m = max(2, self.params.batch_size)
        h = max(m // 2, 1)
        if n <= m:
            ranked = yield RankWindows([keys])
            return ranked[0]
        want = spec.effective_limit(n)
        n_passes = math.ceil(want / h)

        # static schedule: every window op in sequential order
        ops: list[int] = []  # window start positions
        for p in range(n_passes):
            fixed = p * h
            if fixed >= n - 1:
                break
            ops.extend(_pass_starts(n, m, h, fixed))

        # Wavefront rounds by dependency level: op k conflicts with every
        # earlier op whose start lies within (s-m, s+m) (overlapping [s, s+m)
        # regions), and ops sharing a start conflict pairwise, so their
        # levels are strictly increasing — the LAST earlier op at each
        # conflicting start carries the max level.  level[k] = 1 + max over
        # those predecessors; ops of one level have pairwise-disjoint
        # regions (conflicting ops always differ in level), so each level is
        # one RankWindows probe set applied in place.  This is a
        # dependency-preserving reorder computed in O(ops * m/h * log).
        at: dict[int, list[int]] = {}
        for k, s in enumerate(ops):
            at.setdefault(s, []).append(k)
        starts_sorted = sorted(at)
        levels = [0] * len(ops)
        n_levels = 0
        for k, s in enumerate(ops):
            lvl = 0
            lo = bisect.bisect_right(starts_sorted, s - m)
            hi = bisect.bisect_left(starts_sorted, s + m)
            for s2 in starts_sorted[lo:hi]:
                lst = at[s2]
                pos = bisect.bisect_left(lst, k) - 1
                if pos >= 0:  # last earlier op at a conflicting start
                    lvl = max(lvl, levels[lst[pos]] + 1)
            levels[k] = lvl
            n_levels = max(n_levels, lvl + 1)
        by_level: list[list[int]] = [[] for _ in range(n_levels)]
        for k, lvl in enumerate(levels):
            by_level[lvl].append(k)  # index order within a level
        for round_ids in by_level:
            ranked = yield RankWindows([keys[ops[k]:ops[k] + m]
                                        for k in round_ids])
            for k, r in zip(round_ids, ranked):
                keys[ops[k]:ops[k] + m] = r
        return keys

    @classmethod
    def est_calls(cls, n: int, k: Optional[int], params: PathParams) -> float:
        m = max(2, params.batch_size)
        h = max(m // 2, 1)
        if n <= m:
            return 1.0
        want = n if k is None else min(k, n)
        passes = math.ceil(want / h)
        per_pass = max(1, math.ceil((n - m) / h) + 1)
        return float(passes * per_pass)
