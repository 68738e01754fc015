"""Access-path base machinery.

Direction handling: every algorithm produces *output order* directly —
``result.order[0]`` is the first row the query returns; ``LIMIT K`` is always
``order[:K]``.  The :class:`Ordering` adapter folds ASC/DESC into the oracle
verbs so the algorithms themselves are direction-free:

 * ``sort_key(score)``   — lower sorts earlier in the output,
 * ``before(a, b)``      — True iff ``a`` must precede ``b`` in the output,
 * ``window(keys)``      — listwise window ranking in output order.

Probe plans: algorithms are *resumable* — each path's ``_plan`` generator
yields typed probe sets (``executor.ComparePairs`` / ``ScoreEach`` /
``ScoreBatches`` / ``RankWindows``) describing every call whose inputs are
already known, and suspends until the results come back at the yield point.
Solo execution drives one plan through ``executor.drive_plan``, resolving
each probe set with the matching :class:`Ordering` round verb
(``before_many``, ``scores_each``, ``scores_many``, ``windows``) — so the
retry/binary-split fallback and billing are the familiar synchronous
semantics, and the oracle still executes a round as one backend submission
where it can (ModelOracle: one padded prefill) and as a sequential loop
otherwise.  ``executor.ProbePlanExecutor`` drives many suspended plans at
once — concurrent queries, optimizer pilot candidates — merging same-kind
probes from different plans into shared serving submissions.  See DESIGN.md
"Probe-plan executor".

Cost models: Table 1 of the paper, used both for optimizer cost extrapolation
(Sec. 5.1) and for the Table-1 benchmark that checks our empirical call counts
against the asymptotics.

Counterpart of ``src/repro/core/access_paths/base.py`` (copied; only imports and
cross-references point at the port)."""
from __future__ import annotations

import abc
import math
from dataclasses import dataclass
from typing import Callable, Optional, Sequence

from ..executor import drive_plan
from ..types import InvalidOutputError, Key, SortResult, SortSpec
from ..oracles.base import Oracle


class Ordering:
    """Direction-folding adapter over an Oracle, with retry/split fallback for
    structurally invalid listwise outputs (production behavior: one salted
    retry, then binary split).  Point verbs (``before``/``scores``/``window``)
    have round counterparts (``before_many``/``scores_each``/``scores_many``/
    ``windows``) that submit a whole set of independent calls at once,
    preserving the fallback per sub-batch."""

    def __init__(self, oracle: Oracle, spec: SortSpec):
        self.oracle = oracle
        self.spec = spec
        self.sign = -1.0 if spec.descending else 1.0

    # -- direction folding --------------------------------------------------
    # Shared by the synchronous round verbs below and by the executor's
    # deferred-round path (which reads raw oracle results back from the
    # scheduler drain and must apply the exact same fold).
    def fold_scores(self, raw: Sequence[float]) -> list[float]:
        return [self.sign * s for s in raw]

    def fold_compares(self, cmps: Sequence[int]) -> list[bool]:
        if self.spec.descending:
            return [c > 0 for c in cmps]
        return [c < 0 for c in cmps]

    def fold_window_result(self, ranked: Sequence[Key]) -> list[Key]:
        return list(reversed(ranked)) if self.spec.descending else list(ranked)

    # -- value-based ---------------------------------------------------------
    def scores(self, keys: Sequence[Key]) -> list[float]:
        """Sort keys ascending by these values to get output order."""
        raw = self._score_with_fallback(list(keys))
        return [self.sign * s for s in raw]

    def _score_with_fallback(self, keys: list[Key]) -> list[float]:
        try:
            return self.oracle.score_batch(keys, self.spec.criteria)
        except InvalidOutputError:
            if len(keys) == 1:
                raise
            return self._score_split(keys)

    def _score_split(self, keys: list[Key]) -> list[float]:
        """Binary-split re-derivation after a (billed) structural failure;
        only valid for len(keys) >= 2."""
        mid = len(keys) // 2
        return (self._score_with_fallback(keys[:mid])
                + self._score_with_fallback(keys[mid:]))

    def scores_each(self, keys: Sequence[Key]) -> list[float]:
        """One round of independent single-key scores (pointwise billing),
        executed as one backend submission where the oracle supports it.
        A single-key structural failure is unrecoverable (nothing to split),
        so it propagates as InvalidOutputError — matching the sequential
        pointwise loop — except that the whole round has already been
        attempted and billed by then, not just the keys before the failure."""
        keys = list(keys)
        if not keys:
            return []
        try:
            raw = self.oracle.try_score_each(keys, self.spec.criteria)
        except InvalidOutputError:  # wholesale backend failure: split round
            if len(keys) == 1:
                return self.scores(keys)  # point-call path (may re-raise)
            mid = len(keys) // 2
            return self.scores_each(keys[:mid]) + self.scores_each(keys[mid:])
        out = []
        for k, v in zip(keys, raw):
            if v is None:  # billed failure; nothing to split at size 1
                raise InvalidOutputError(
                    f"single-key score failed for uid={k.uid}")
            out.append(self.sign * v)
        return out

    def scores_many(self, chunks: Sequence[Sequence[Key]]) -> list[list[float]]:
        """One round of independent m-key scoring calls (external pointwise),
        one backend submission where supported.  Per-chunk failure isolation:
        only a structurally failing chunk takes the (already billed) binary
        split path, exactly as it would when executed sequentially."""
        chunks = [list(c) for c in chunks]
        if not chunks:
            return []
        try:
            raw = self.oracle.try_score_batches(chunks, self.spec.criteria)
        except InvalidOutputError:  # wholesale backend failure: split round
            if len(chunks) == 1:
                return [self.scores(chunks[0])]
            mid = len(chunks) // 2
            return self.scores_many(chunks[:mid]) + self.scores_many(chunks[mid:])
        out: list[list[float]] = []
        for c, vals in zip(chunks, raw):
            if vals is None:  # billed failure: split (or give up at size 1)
                if len(c) == 1:
                    raise InvalidOutputError(
                        f"single-key score failed for uid={c[0].uid}")
                vals = self._score_split(c)
            out.append([self.sign * s for s in vals])
        return out

    # -- pairwise --------------------------------------------------------------
    def before(self, a: Key, b: Key) -> bool:
        """True iff a precedes b in the output order."""
        cmp = self.oracle.compare(a, b, self.spec.criteria)  # +1: a larger
        return (cmp > 0) if self.spec.descending else (cmp < 0)

    def before_many(self, pairs: Sequence[tuple[Key, Key]]) -> list[bool]:
        """One round of independent comparisons — ``[a precedes b in output]``
        per pair — executed as one backend submission where the oracle
        supports it, with binary-split retry per sub-batch on failure."""
        pairs = list(pairs)
        if not pairs:
            return []
        try:
            cmps = self.oracle.compare_batch(pairs, self.spec.criteria)
        except InvalidOutputError:
            if len(pairs) == 1:
                return [self.before(*pairs[0])]
            mid = len(pairs) // 2
            return self.before_many(pairs[:mid]) + self.before_many(pairs[mid:])
        return self.fold_compares(cmps)

    # -- listwise ----------------------------------------------------------------
    def window(self, keys: Sequence[Key]) -> list[Key]:
        """Permutation of keys in output order (first = returned first)."""
        keys = list(keys)
        ranked = self._rank_with_fallback(keys)
        return list(reversed(ranked)) if self.spec.descending else ranked

    def windows(self, batches: Sequence[Sequence[Key]]) -> list[list[Key]]:
        """Batched windows (parallel run generation): one backend submission
        where the oracle supports it.  Per-window failure isolation
        (``try_rank_batches``): a structurally failing window takes its own
        (already billed) split path; its round-mates are not re-billed."""
        batches = [list(b) for b in batches]
        if not batches:
            return []
        try:
            ranked = self.oracle.try_rank_batches(batches, self.spec.criteria)
        except InvalidOutputError:  # wholesale backend failure: split round
            if len(batches) == 1:
                return [self.window(batches[0])]
            mid = len(batches) // 2
            return self.windows(batches[:mid]) + self.windows(batches[mid:])
        out: list[list[Key]] = []
        for b, r in zip(batches, ranked):
            if r is None:
                r = self._rank_split(b)
            out.append(self.fold_window_result(r))
        return out

    def _rank_with_fallback(self, keys: list[Key]) -> list[Key]:
        try:
            return self.oracle.rank_batch(keys, self.spec.criteria)
        except InvalidOutputError:
            return self._rank_split(keys)

    def _rank_split(self, keys: list[Key]) -> list[Key]:
        """Split re-ranking after a (billed) structural failure."""
        if len(keys) <= 2:
            # degrade to a pairwise comparison
            if len(keys) < 2:
                return keys
            a, b = keys
            return [a, b] if self.oracle.compare(a, b, self.spec.criteria) < 0 else [b, a]
        mid = len(keys) // 2
        lo = self._rank_with_fallback(keys[:mid])
        hi = self._rank_with_fallback(keys[mid:])
        # cheap interleave by a final attempt on the halves' concatenation:
        # merge by latent-free round-robin is meaningless, so re-rank halves
        # pairwise-merged via compare of run heads (bounded extra calls).
        out: list[Key] = []
        i = j = 0
        while i < len(lo) and j < len(hi):
            if self.oracle.compare(lo[i], hi[j], self.spec.criteria) < 0:
                out.append(lo[i]); i += 1
            else:
                out.append(hi[j]); j += 1
        out.extend(lo[i:]); out.extend(hi[j:])
        return out


@dataclass(frozen=True)
class PathParams:
    batch_size: int = 4      # m, for external paths
    votes: int = 1           # v, for quick sort
    max_batch: int = 32      # M cap in Alg. 1
    agreement: float = 0.9   # θ in Alg. 1
    agreement_atol: float = 0.35  # |Δscore| tolerance counted as agreement
    # Round batching: emit each level's independent oracle calls as one
    # backend submission (ModelOracle -> one padded prefill).  False restores
    # the seed's sequential point-call structure — same outputs under any
    # deterministic-per-prompt oracle, more serving submissions; kept as a
    # diagnostic baseline for benchmarks/table4_submissions.py.
    coalesce: bool = True


class AccessPath(abc.ABC):
    """One physical implementation of LLM ORDER BY."""

    name: str = "base"

    def __init__(self, params: PathParams = PathParams()):
        self.params = params

    @abc.abstractmethod
    def _plan(self, keys: Sequence[Key], spec: SortSpec):
        """Resumable probe plan: a generator that yields typed probe sets
        (``executor.ComparePairs`` / ``ScoreEach`` / ``ScoreBatches`` /
        ``RankWindows`` / ``SerialProbe``) and receives their
        direction-folded results at the yield point; returns keys in output
        order (may exceed ``spec.effective_limit``; ``execute`` truncates).
        The plan never touches the oracle itself, so its driver decides
        whether a round runs as one submission (solo), element-wise
        (``coalesce=False`` diagnostic baseline), or merged with other
        plans' rounds (``executor.ProbePlanExecutor``)."""

    def execute(self, keys: Sequence[Key], oracle: Oracle, spec: SortSpec) -> SortResult:
        """Solo synchronous execution: drive this path's plan to completion,
        resolving each probe set through :class:`Ordering`'s round verbs."""
        snap = oracle.ledger.snapshot()
        ordering = Ordering(oracle, spec)
        out = drive_plan(self._plan(list(keys), spec), ordering,
                         coalesce=self.params.coalesce)
        k = spec.effective_limit(len(keys))
        out = out[:k]
        view = oracle.ledger.since(snap)
        return SortResult(
            order=out, path=self.name, params=self.describe_params(),
            n_calls=view.n_calls, input_tokens=view.input_tokens,
            output_tokens=view.output_tokens, cost=view.cost(oracle.prices),
        )

    def describe_params(self) -> dict:
        return {"batch_size": self.params.batch_size, "votes": self.params.votes}

    # ---- Table 1 cost model ------------------------------------------------
    @classmethod
    @abc.abstractmethod
    def est_calls(cls, n: int, k: Optional[int], params: PathParams) -> float:
        """Expected number of LLM calls (Table 1)."""

    @classmethod
    def scale_factor(cls, n_full: int, n_sample: int, k: Optional[int],
                     params: PathParams) -> float:
        """Cost-extrapolation ratio used by the optimizer (Sec. 5.1,
        Examples 5.1/5.2): estimated_full = sampled_cost x this."""
        lo = cls.est_calls(n_sample, k, params)
        hi = cls.est_calls(n_full, k, params)
        return hi / max(lo, 1e-9)


_REGISTRY: dict[str, Callable[..., AccessPath]] = {}


def register(name: str):
    def deco(cls):
        cls.name = name
        _REGISTRY[name] = cls
        return cls
    return deco


def make_path(name: str, params: PathParams = PathParams()) -> AccessPath:
    return _REGISTRY[name](params)


def available_paths() -> list[str]:
    return sorted(_REGISTRY)


def _log2(x: float) -> float:
    return math.log2(max(x, 1.0))
