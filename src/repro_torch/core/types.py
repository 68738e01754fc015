"""Core datatypes for the LLM ORDER BY operator.

A *key* is the unit being ordered (a row, passage, review, ...).  Access paths
only ever look at ``uid`` and ``text``; ``latent`` is the hidden ground-truth
ordering value used by the simulated oracle and by evaluation metrics — real
deployments simply leave it as ``nan``.

Counterpart of ``src/repro/core/types.py`` (copied; only imports and
cross-references point at the port)."""
from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass, field
from typing import Optional, Sequence


@dataclass(frozen=True)
class Key:
    """One sortable item."""

    uid: int
    text: str
    latent: float = math.nan  # hidden ground truth (simulation / eval only)

    def tokens(self) -> int:
        """Crude token estimate (~4 chars/token), matching API billing."""
        return max(1, len(self.text) // 4)


@dataclass(frozen=True)
class SortSpec:
    """The logical ORDER BY clause: criteria text, direction, optional LIMIT."""

    criteria: str
    descending: bool = False
    limit: Optional[int] = None

    def effective_limit(self, n: int) -> int:
        return n if self.limit is None else min(self.limit, n)


class InvalidOutputError(RuntimeError):
    """Raised when the (simulated or real) LLM output fails structural checks.

    Mirrors the paper's JSON-decode / wrong-item-count failure mode observed
    for large listwise batches (Sec. 4.2).
    """


@dataclass
class SortResult:
    """Output of one access-path execution."""

    order: list[Key]                       # output order; [:limit] already applied
    path: str                              # access path name
    params: dict = field(default_factory=dict)
    n_calls: int = 0
    input_tokens: int = 0
    output_tokens: int = 0
    cost: float = 0.0

    def uids(self) -> list[int]:
        return [k.uid for k in self.order]


def as_keys(texts: Sequence[str], latents: Optional[Sequence[float]] = None) -> list[Key]:
    """Convenience constructor used by examples and tests."""
    if latents is None:
        latents = [math.nan] * len(texts)
    return [Key(uid=i, text=t, latent=float(z)) for i, (t, z) in enumerate(zip(texts, latents))]


def replace(key: Key, **kw) -> Key:
    return dataclasses.replace(key, **kw)
