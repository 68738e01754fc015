"""World-knowledge gate via membership inference (Sec. 5.2).

Runs the Inquiry Prompt (Prompt Block 4) on a sample; if 100% of sampled keys
are recognized as training-corpus members, the optimizer short-circuits to the
pointwise path — the model is acting as a reliable knowledge retriever and the
derived values probe parametric memory directly.

Counterpart of ``src/repro/core/optimizer/membership.py`` (copied; only imports and
cross-references point at the port)."""
from __future__ import annotations

from typing import Sequence

from ..executor import InquireEach
from ..types import Key
from ..oracles.base import Oracle


def membership_plan(sample: Sequence[Key]):
    """Probe-plan form of the gate: the whole sample's inquiries are ONE
    ``InquireEach`` round, so under the optimizer's pilot executor the gate
    rides the same scheduling tick (and, on a ModelOracle backend, the same
    merged serving drain) as the candidates' first rounds.  Returns the
    membership rate."""
    sample = list(sample)
    if not sample:
        return 0.0
    hits = yield InquireEach(sample)
    return sum(hits) / len(sample)


def membership_rate(sample: Sequence[Key], oracle: Oracle, criteria: str) -> float:
    if not sample:
        return 0.0
    # one round: all inquiries are independent, so the ModelOracle executes
    # them as a single padded serving submission (billed per key)
    hits = sum(oracle.inquire_batch(list(sample), criteria))
    return hits / len(sample)


def is_world_knowledge(sample: Sequence[Key], oracle: Oracle, criteria: str,
                       threshold: float = 1.0) -> tuple[bool, float]:
    """Strict threshold (default 100%): false negatives merely fall back to
    the Judge/Borda stages, false positives would mis-route reasoning queries
    to an uncalibrated pointwise scorer."""
    rate = membership_rate(sample, oracle, criteria)
    return rate >= threshold, rate
