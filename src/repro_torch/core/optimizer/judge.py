"""LLM-as-Judge candidate selection (Sec. 5.4, Prompt Block 5).

The judge oracle (paper: always the strongest model, Llama3.1-405b) sees the
sampled keys, the ranking criteria, and every candidate's output ranking, and
returns the identifier of the best-sorted candidate.  Long prompts degrade
judge reliability (Sec. 6.2) — the simulated oracle models that as noise
proportional to prompt length.

Counterpart of ``src/repro/core/optimizer/judge.py`` (copied; only imports and
cross-references point at the port)."""
from __future__ import annotations

from typing import Sequence

from ..types import Key
from ..oracles.base import Oracle


def judge_select(sample: Sequence[Key], criteria: str,
                 candidate_orders: Sequence[Sequence[Key]],
                 judge_oracle: Oracle) -> int:
    """Index of the winning candidate according to the judge."""
    return judge_oracle.judge(list(sample), criteria,
                              [list(c) for c in candidate_orders])
