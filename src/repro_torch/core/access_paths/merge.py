"""LLM external merge sort — the paper's new algorithm (Sec. 3.2, Alg. 4/5).

Phase 1 (run generation): chunks of ``m`` keys are each sorted with one
listwise call.  Phase 2 (iterative merging): sorted runs are merged two at a
time.  The two-way merge (Alg. 5) keeps a sliding buffer of up to ``h = m/2``
keys from each run, asks the LLM for a partial order of the buffer, and emits
ranked items until one side's buffered portion is exhausted — at which point
the buffer must be refilled, because the unseen next element of the exhausted
run may precede the survivors.

LIMIT-K pushdown: merged runs are truncated to K, so run sizes stop growing at
K and each subsequent round halves the number of runs — a geometric series
bounded by O(N/m), giving O(N/m * (2 + log K/m)) total calls (Table 1).

Probe plan: Phase 1 is one ``RankWindows`` probe set (the paper's "in
parallel" run generation).  In Phase 2 every merge of a round advances in
lockstep — each step gathers the current window buffer of every unfinished
merge cursor and suspends as ONE ``RankWindows`` probe set, so a round costs
max-refills submissions instead of sum-of-refills, and the executor can
interleave these steps with other plans' rounds.

Counterpart of ``src/repro/core/access_paths/merge.py`` (copied; only imports and
cross-references point at the port)."""
from __future__ import annotations

import math
from typing import Optional, Sequence

from ..executor import RankWindows
from ..types import Key, SortSpec
from .base import AccessPath, PathParams, _log2, register


class _MergeCursor:
    """State of one in-flight two-way merge (Alg. 5): run pointers, emitted
    output, and the current window buffer awaiting an LLM ranking.  Encodes
    the emission/consistency-repair logic of the sequential Alg. 5 loop —
    including the LIMIT-K early stop at ``cap`` — so lockstep execution is
    call-for-call identical to merging the pairs one at a time."""

    def __init__(self, l1: list[Key], l2: list[Key], h: int,
                 cap: Optional[int] = None):
        self.l1, self.l2, self.h, self.cap = l1, l2, h, cap
        self.i = self.j = 0
        self.out: list[Key] = []
        self.done = False
        self._fast_forward()

    def _fast_forward(self) -> None:
        """Emit the tail without an oracle call once one run is exhausted;
        stop — issuing no further windows — once ``cap`` items are emitted
        (ranking positions past K can never reach the output)."""
        if self.done:
            return
        if self.cap is not None and len(self.out) >= self.cap:
            self.out = self.out[:self.cap]; self.done = True
        elif self.i >= len(self.l1):
            self.out.extend(self.l2[self.j:]); self.done = True
        elif self.j >= len(self.l2):
            self.out.extend(self.l1[self.i:]); self.done = True
        if self.done and self.cap is not None:
            self.out = self.out[:self.cap]

    def buffer(self) -> list[Key]:
        """The next window to rank (only valid while not done)."""
        t1 = min(self.h, len(self.l1) - self.i)
        t2 = min(self.h, len(self.l2) - self.j)
        return self.l1[self.i:self.i + t1] + self.l2[self.j:self.j + t2]

    def consume(self, ranked: list[Key]) -> None:
        """Apply one ranked buffer: emit until one side's buffered portion
        is exhausted, then advance the pointers.

        Consistency repair: the paper's emission loop advances each run's
        pointer by the COUNT of items emitted from that run, which implicitly
        assumes the LLM's buffer ranking preserves each run's internal order.
        A noisy ranking can invert two same-run items, double-emitting one
        and dropping another.  We therefore *project* the ranked order onto
        the runs: when the ranking says "next emit from run r", we emit run
        r's next unconsumed item (runs are already sorted, so for a faithful
        oracle this is the identity; under noise it guarantees the output is
        a permutation)."""
        t1 = min(self.h, len(self.l1) - self.i)
        t2 = min(self.h, len(self.l2) - self.j)
        in_l1 = {k.uid for k in self.l1[self.i:self.i + t1]}
        e1 = e2 = 0
        for x in ranked:
            if x.uid in in_l1:
                self.out.append(self.l1[self.i + e1])  # next unconsumed, run 1
                e1 += 1
            else:
                self.out.append(self.l2[self.j + e2])  # next unconsumed, run 2
                e2 += 1
            if e1 == t1 or e2 == t2:
                break  # one side exhausted within this window -> refill
        self.i += e1
        self.j += e2
        self._fast_forward()


@register("ext_merge")
class ExternalMergeSort(AccessPath):
    def _plan(self, keys: Sequence[Key], spec: SortSpec):
        keys = list(keys)
        m = max(2, self.params.batch_size)
        h = max(m // 2, 1)
        cap = spec.limit  # truncate merged runs at K (Sec. 3.3)
        if not keys:
            return []

        # Phase 1: run generation — independent listwise calls, one round.
        chunks = [keys[i:i + m] for i in range(0, len(keys), m)]
        runs: list[list[Key]] = yield RankWindows(chunks)
        if cap is not None:
            # LIMIT-K pushdown starts at the runs themselves: a run's item
            # at position >= K trails K earlier run-mates in every merge
            runs = [r[:cap] for r in runs]

        # Phase 2: iterative two-way merging in lockstep — each step gathers
        # the current buffer of every unfinished merge into one round.
        while len(runs) > 1:
            nxt: list[list[Key]] = []
            slots: list = []  # per output slot: cursor | carried run
            for i in range(0, len(runs), 2):
                if i + 1 < len(runs):
                    slots.append(_MergeCursor(runs[i], runs[i + 1], h, cap))
                else:
                    slots.append(runs[i])  # odd run carried forward
            while True:
                active = [c for c in slots
                          if isinstance(c, _MergeCursor) and not c.done]
                if not active:
                    break
                ranked = yield RankWindows([c.buffer() for c in active])
                for c, r in zip(active, ranked):
                    c.consume(r)
            for s in slots:
                merged = s.out if isinstance(s, _MergeCursor) else s
                if cap is not None:
                    merged = merged[:cap]  # incl. carried odd runs, so run
                    # sizes actually stop growing at K
                nxt.append(merged)
            runs = nxt
        return runs[0] if runs else []

    # ---- Table 1 --------------------------------------------------------------
    @classmethod
    def est_calls(cls, n: int, k: Optional[int], params: PathParams) -> float:
        m = max(2, params.batch_size)
        runs = math.ceil(n / m)
        if runs <= 1:
            return 1.0
        if k is None or k >= n:
            # run generation + log2(runs) merge rounds, each ~2N/m windows
            return runs * (1 + _log2(runs))
        return (n / m) * (2 + _log2(max(k, m) / m))
