"""Cost estimation (Sec. 5.1).

The optimizer runs every candidate on a small sample, observes the *actual*
dollar cost, then extrapolates to the full dataset by scaling with the Table-1
call-complexity ratio (Examples 5.1 / 5.2: pointwise scales linearly, external
bubble quadratically, ...).  ``estimate_full_cost`` is that scaling; the
Table-2 benchmark validates it against true execution cost.

Counterpart of ``src/repro/core/optimizer/cost_model.py`` (copied; only imports and
cross-references point at the port)."""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

from ..access_paths.base import PathParams, _REGISTRY


@dataclass(frozen=True)
class CandidateSpec:
    """One entry of the optimizer's candidate pool.

    ``rung``/``threshold`` are the model-cascade ladder dimension: a
    candidate with ``threshold`` set is executed on
    ``oracle.at_threshold(threshold)`` (draft-first rounds, escalating
    low-margin probes), so the optimizer explores (path, rung, threshold)
    tuples under one budget.  ``threshold=None`` is the plain large-model
    candidate.  ``rung`` groups candidates that share a $/est_call rate —
    cascade rungs are cheaper per call than large-only, so the pilot
    phase calibrates each rung separately."""

    path: str                      # registry name ("pointwise", "ext_merge", ...)
    params: PathParams = PathParams()
    label: str = ""
    rung: str = ""                 # rate-calibration group ("" = large-only)
    threshold: Optional[float] = None  # cascade escalation threshold

    def __post_init__(self):
        if self.threshold is not None and not self.rung:
            object.__setattr__(self, "rung", f"t{self.threshold:g}")
        if not self.label:
            object.__setattr__(self, "label", self.default_label())

    def default_label(self) -> str:
        if self.path == "quick":
            base = ("quick" if self.params.votes <= 1
                    else f"quick_{self.params.votes}")
        elif self.path.startswith("ext_") and self.path != "ext_pointwise":
            base = f"{self.path}_{self.params.batch_size}"
        else:
            base = self.path
        if self.threshold is not None:
            base += f"@t{self.threshold:g}"
        return base

    @property
    def comparison_based(self) -> bool:
        return self.path in ("quick", "ext_bubble", "ext_merge")

    def make(self):
        return _REGISTRY[self.path](self.params)


def default_candidates(min_batch: int = 4) -> list[CandidateSpec]:
    """The paper's pool: both value-based paths plus all comparison-based
    paths at their *minimum viable batch size* (Sec. 5.3: the test-time
    scaling insight says bigger batches only trade quality for cost inside
    one path, so the pool explores paths, not batch sizes)."""
    return [
        CandidateSpec("pointwise"),
        CandidateSpec("ext_pointwise", PathParams(batch_size=min_batch)),
        CandidateSpec("quick", PathParams(votes=1)),
        CandidateSpec("quick", PathParams(votes=3)),
        CandidateSpec("ext_bubble", PathParams(batch_size=min_batch)),
        CandidateSpec("ext_merge", PathParams(batch_size=min_batch)),
    ]


def ladder_candidates(pool: "list[CandidateSpec]",
                      thresholds: "list[float]") -> "list[CandidateSpec]":
    """Expand a candidate pool along the cascade ladder: the original
    large-only candidates plus, for every escalation threshold, a cascade
    variant of each path.  Call complexity (Table 1) is threshold-invariant
    — a cascade round issues the same logical calls, only cheaper ones —
    so ``est_calls`` stays path-driven and the per-rung $/est_call rate
    carries the whole cost difference."""
    out = list(pool)
    for t in thresholds:
        out.extend(CandidateSpec(c.path, c.params, threshold=float(t))
                   for c in pool)
    return out


def estimate_full_cost(spec: CandidateSpec, sampled_cost: float,
                       n_sample: int, n_full: int, k: Optional[int]) -> float:
    """sampled_cost x complexity(N, K) / complexity(n_sample, K_sample)."""
    cls = _REGISTRY[spec.path]
    k_sample = None if k is None else min(k, n_sample)
    lo = cls.est_calls(n_sample, k_sample, spec.params)
    hi = cls.est_calls(n_full, k, spec.params)
    return sampled_cost * hi / max(lo, 1e-9)


def est_sample_calls(spec: CandidateSpec, n_sample: int,
                     k: Optional[int]) -> float:
    """Table-1 call-complexity of one candidate's SAMPLE run — the
    denominator of :func:`estimate_full_cost` and the per-candidate call
    predictor behind budget-capped pilot overlap."""
    k_sample = None if k is None else min(k, n_sample)
    return _REGISTRY[spec.path].est_calls(n_sample, k_sample, spec.params)


def dollars_per_est_call(observed: "list[tuple[CandidateSpec, float]]",
                         n_sample: int, k: Optional[int]) -> Optional[float]:
    """Measured $/est_call over completed pilot runs: total observed
    sampled cost divided by total Table-1 estimated calls.  ``observed``
    is [(candidate, actual sampled $)]; returns None until at least one
    pilot has completed (the predictor is uncalibrated)."""
    if not observed:
        return None
    total_cost = sum(cost for _spec, cost in observed)
    total_calls = sum(est_sample_calls(spec, n_sample, k)
                      for spec, _cost in observed)
    return total_cost / max(total_calls, 1e-9)


def predict_sample_cost(spec: CandidateSpec, n_sample: int, k: Optional[int],
                        rate: float) -> float:
    """Predicted sample-run spend of a not-yet-run candidate: its Table-1
    sample call complexity times the measured $/est_call ``rate``.  Used by
    the optimizer to admit OVERLAPPING pilots under a budget cap — a
    candidate is co-admitted only while observed spend plus every in-flight
    candidate's full prediction stays under the cap, so overshoot is
    bounded by prediction error rather than by whole in-flight pilots."""
    return est_sample_calls(spec, n_sample, k) * rate
