"""Value-based access paths (Sec. 3.1).

* :class:`Pointwise` — one LLM call per key, O(N).
* :class:`ExternalPointwise` — m keys per call, O(N/m), with the
  agreement-based adaptive batch-size search of Algorithm 1 (O(log2 m) billed
  calls thanks to the client-side cache).

Both plans are single-round: every scoring call is independent, so the whole
derivation is ONE ``ScoreEach`` / ``ScoreBatches`` probe set.  Algorithm 1's
batch-size search is the one inherently *sequential* subroutine in the
access-path layer (each doubling decision depends on the previous round's
scores), so it is emitted as a ``SerialProbe`` — resolved immediately by its
driver, never merged across plans.

Counterpart of ``src/repro/core/access_paths/pointwise.py`` (copied; only imports and
cross-references point at the port)."""
from __future__ import annotations

import math
from typing import Optional, Sequence

import numpy as np

from ..executor import ScoreBatches, ScoreEach, SerialProbe
from ..types import InvalidOutputError, Key, SortSpec
from ..oracles.cache import CachingOracle
from .base import AccessPath, Ordering, PathParams, register


def _stable_sort_by(keys: Sequence[Key], values: Sequence[float]) -> list[Key]:
    order = np.argsort(np.asarray(values, dtype=np.float64), kind="stable")
    return [keys[i] for i in order]


@register("pointwise")
class Pointwise(AccessPath):
    def _plan(self, keys: Sequence[Key], spec: SortSpec):
        keys = list(keys)
        vals = yield ScoreEach(keys)   # all N single-key calls: one round
        return _stable_sort_by(keys, vals)

    @classmethod
    def est_calls(cls, n: int, k: Optional[int], params: PathParams) -> float:
        return float(n)


@register("ext_pointwise")
class ExternalPointwise(AccessPath):
    """Batched value derivation with adaptive batch sizing (Algorithm 1)."""

    def choose_batch_size(self, keys: Sequence[Key], ordering: Ordering) -> int:
        """Algorithm 1: double m while merged per-batch scores agree with the
        combined 2m-batch scores.  Caching makes re-used prompts free."""
        p = self.params
        oracle = ordering.oracle
        cached = oracle if isinstance(oracle, CachingOracle) else CachingOracle(oracle)
        crit = ordering.spec.criteria
        m = 2
        while 2 * m < len(keys) and m < p.max_batch:
            b1 = list(keys[:m])
            b2 = list(keys[m:2 * m])
            b3 = b1 + b2
            try:
                # raw calls (no split-retry fallback): Alg. 1 must observe
                # structural failures and stop doubling
                v1 = cached.score_batch(b1, crit)
                v2 = cached.score_batch(b2, crit)
                v3 = cached.score_batch(b3, crit)
            except InvalidOutputError:
                break
            v12 = v1 + v2
            agree = sum(1 for a, b in zip(v12, v3) if abs(a - b) <= p.agreement_atol)
            alpha = agree / (2 * m)
            if alpha >= p.agreement:
                m *= 2
            else:
                return m
        return m

    def _plan(self, keys: Sequence[Key], spec: SortSpec):
        keys = list(keys)
        if self.params.batch_size == 0:
            m = yield SerialProbe(lambda o: self.choose_batch_size(keys, o))
        else:
            m = self.params.batch_size
        self._chosen_m = m
        chunks = [keys[i:i + m] for i in range(0, len(keys), m)]
        # all N/m m-key calls are independent: one round
        nested = yield ScoreBatches(chunks)
        vals = [v for vs in nested for v in vs]
        return _stable_sort_by(keys, vals)

    def describe_params(self) -> dict:
        d = super().describe_params()
        if getattr(self, "_chosen_m", None) is not None:
            d["chosen_batch_size"] = self._chosen_m
        return d

    @classmethod
    def est_calls(cls, n: int, k: Optional[int], params: PathParams) -> float:
        m = max(params.batch_size, 2)
        return math.ceil(n / m) + math.log2(m)  # scoring + Alg.1 probes
