"""Borda-count consensus aggregation (Sec. 5.5).

Each candidate ranking is a ballot: the item in output position ``p`` of a
ballot over ``s`` items receives ``s - p`` points (truncated ballots award 0
to unlisted items — standard partial-ballot Borda, Emerson '13).  Summing over
ballots yields the *gold ranking*: the collective preference used as a proxy
source of truth.

This numpy implementation is the semantic reference for the
``kernels/borda_count`` Pallas kernel (one-hot matmul formulation on TPU).

Counterpart of ``src/repro/core/optimizer/borda.py`` (copied; only imports and
cross-references point at the port)."""
from __future__ import annotations

from typing import Sequence

import numpy as np


def borda_scores(ballots: Sequence[Sequence[int]], universe: Sequence[int]) -> dict[int, float]:
    """Total Borda points per uid over all ballots."""
    scores = {u: 0.0 for u in universe}
    for ballot in ballots:
        s = len(ballot)
        for pos, uid in enumerate(ballot):
            if uid in scores:
                scores[uid] += float(s - pos)
    return scores


def borda_consensus(ballots: Sequence[Sequence[int]], universe: Sequence[int]) -> list[int]:
    """Gold ranking: uids by descending total points (uid tie-break)."""
    scores = borda_scores(ballots, universe)
    return sorted(universe, key=lambda u: (-scores[u], u))


def borda_matrix(ballots_idx: np.ndarray, n_items: int) -> np.ndarray:
    """Vectorized points-per-item from an (R, S) index matrix of ballots.

    ``ballots_idx[r, p]`` is the item index at position p of ballot r; -1 pads
    truncated ballots.  Mirrors the kernels/borda_count layout exactly.
    """
    r, s = ballots_idx.shape
    pts = np.zeros(n_items, dtype=np.float64)
    pos_pts = np.arange(s, 0, -1, dtype=np.float64)  # s - p
    for i in range(r):
        valid = ballots_idx[i] >= 0
        np.add.at(pts, ballots_idx[i][valid], pos_pts[valid])
    return pts
