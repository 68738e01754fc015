"""Own copy of ``src/repro/serving/locality.py`` (host-side planning, no JAX
in it; nothing left out).

Locality-creating probe scheduling (GGR-shaped group-and-reorder).

The prefix-KV cache and the unified step loop made prefix reuse
*reactive*: a step gap's merged probe set is executed in arrival order and
whatever regions happen to recur get cached.  This module actively
*creates* reuse, following the greedy group-and-reorder idea from the
relational LLM-workload optimizers (PAPERS.md: "Optimizing LLM Queries in
Relational Data Analytics Workloads"; Sema's operator runtime): given the
structured rows of one padded-length class, it

 1. **clusters rows by prefix region** — the engine's canonical
    ``_region_key`` (prefix token ids, absolute start position) — so every
    row that can share a cached region sits adjacent in one submission;
 2. **gives each region group its own suffix-prefill window** — the
    power-of-two bucket of the group's longest suffix, instead of one
    class-global window sized by the round's worst row, so short-suffix
    groups stop recomputing prefix tail tokens they could read from KV;
 3. **merges equal-window groups into jobs capped at the LRU capacity** —
    a single job never touches more distinct regions than
    ``prefix_cache_size`` can hold, so a job's working set cannot thrash
    the LRU mid-round;
 4. **orders jobs cold-first / warm-last** — jobs whose regions are
    already LRU-resident run last, leaving recurring regions most-recent
    in the LRU for the NEXT round (greedy eviction-distance maximization).

Invariants (asserted by tests/test_locality.py and benchmarks
table5/table9): reordering is *serving-side only*.  Results are fanned
back by row id, every row's logits stay bit-identical to monolithic
prefill (causal KV slicing is exact at any split — the prefix-cache contract), so
orderings and oracle ledgers are byte-identical (``==``) under any
grouping.  Only ``ServeStats`` (prefill tokens, hits, tokens saved) move.

``prefetch_candidates`` is the prefetch-pipelining half: given the probe
prompts a plan will submit NEXT, it selects the structured prompts whose
region is (a) shared by at least two rows — the engine's routing policy
would run singletons monolithically anyway, so warming them would change
routing and waste fill work — and (b) not already LRU-resident (warming a
resident region would just count a free hit).  The executor enqueues the
survivors as ``PrefixFill`` work so the warm-up rides an earlier step gap
of the unified loop, overlapping in-flight decode instead of serializing
with the round's own fills.
"""
from __future__ import annotations

from typing import Sequence


def _next_pow2(x: int) -> int:
    return 1 << max(x - 1, 0).bit_length()


def group_rows_by_region(selected: Sequence[tuple]) -> list[tuple]:
    """Cluster ``(idx, region_key, suffix_len)`` rows by region key, first
    appearance order, keeping each group's rows in submission order.
    Returns ``[(key, [(idx, suffix_len), ...])]``."""
    groups: dict[tuple, list] = {}
    order: list[tuple] = []
    for idx, key, slen in selected:
        if key not in groups:
            groups[key] = []
            order.append(key)
        groups[key].append((idx, slen))
    return [(key, groups[key]) for key in order]


def group_window(rows: Sequence[tuple], bucket: bool) -> int:
    """One region group's suffix-prefill window: the power-of-two bucket
    (floor 8, matching the engine's class-global scheme) of the group's
    longest suffix — exact when shape bucketing is off."""
    w = max(slen for _, slen in rows)
    return _next_pow2(max(w, 8)) if bucket else w


def plan_window_jobs(selected: Sequence[tuple], *, lru_keys,
                     cache_size: int, bucket: bool = True) -> list[tuple]:
    """The GGR pass for one padded-length class.

    ``selected`` rows are ``(idx, region_key, suffix_len)`` triples already
    chosen for the prefix path (the engine's routing policy).  Returns an
    ordered list of window jobs ``(window, [(idx, region_key), ...])``:
    region-clustered rows, per-group windows merged by equal window size,
    at most ``cache_size`` distinct regions per job, cold jobs before warm
    jobs (see module docstring).  Pure function of its inputs — the engine
    owns all KV state."""
    lru_keys = set(lru_keys)
    by_window: dict[int, list] = {}
    for key, rows in group_rows_by_region(selected):
        by_window.setdefault(group_window(rows, bucket), []).append(
            (key, rows))
    jobs: list[tuple[bool, int, list]] = []   # (warm, window, rows)
    cap = max(cache_size, 1)
    for w in sorted(by_window):
        groups = by_window[w]
        for i in range(0, len(groups), cap):
            chunk = groups[i:i + cap]
            rows = [(idx, key) for key, grp in chunk for idx, _ in grp]
            warm = any(key in lru_keys for key, _ in chunk)
            jobs.append((warm, w, rows))
    # cold-first / warm-last, stable: warm jobs touch the LRU last, so the
    # regions a recurring workload reuses stay most-recent for next round
    jobs.sort(key=lambda j: j[0])
    return [(w, rows) for _, w, rows in jobs]


def prefetch_candidates(engine, prompts: Sequence) -> list:
    """Select the structured prompts of a FUTURE probe round whose prefix
    regions are worth warming ahead of time: regions shared by >= 2
    prompts of the round (singletons would be routed monolithically — the
    engine's routing policy — so a fill would be pure waste AND would flip
    their routing) and not already LRU-resident.  Returns one
    representative prompt per candidate region, ready for
    ``BatchScheduler.submit_prefix_fill``."""
    if not getattr(engine, "prefix_cache_enabled", False):
        return []
    counts: dict[tuple, int] = {}
    rep: dict[tuple, object] = {}
    seen: set = set()
    for p in prompts:
        prefix, suffix = engine._parts(p)
        if prefix is None or (prefix, suffix) in seen:
            # identical prompts are deduplicated by the scheduler before
            # they reach the engine, so region sharing must be counted
            # over UNIQUE prompts — otherwise a duplicated singleton
            # would be warmed and its routing flipped vs no-prefetch
            continue
        seen.add((prefix, suffix))
        pids = tuple(engine.tok.encode(prefix))
        sids = engine.tok.encode(suffix, bos=False)
        cls = engine._pad_class(len(pids) + len(sids))
        key = engine._region_key(pids, sids, cls)
        counts[key] = counts.get(key, 0) + 1
        rep.setdefault(key, p)
    return [rep[key] for key, c in counts.items()
            if c >= 2 and key not in engine._prefix_lru]
