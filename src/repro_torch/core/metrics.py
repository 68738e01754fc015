"""Ranking-quality metrics: Kendall's tau and nDCG@k.

Pure numpy (no scipy in this container).  Conventions follow the paper:
 * Kendall's tau for full-sort benchmarks (NBA heights, world population),
 * nDCG@10 for LIMIT-K / passage-ranking benchmarks (DL19/DL20, TweetEval).

Counterpart of ``src/repro/core/metrics.py`` (copied; only imports and
cross-references point at the port)."""
from __future__ import annotations

import math
from typing import Mapping, Sequence

import numpy as np

from .types import Key


def kendall_tau(order: Sequence[Key], descending: bool = False) -> float:
    """Kendall tau-a between a produced order and the latent ground truth.

    ``order`` is the output order of an access path.  For ascending sorts the
    ideal has latents non-decreasing along the list.  Returns in [-1, 1].
    """
    z = np.asarray([k.latent for k in order], dtype=np.float64)
    if descending:
        z = -z
    n = z.shape[0]
    if n < 2:
        return 1.0
    diff = z[None, :] - z[:, None]          # diff[i, j] = z_j - z_i
    upper = np.triu_indices(n, k=1)
    d = diff[upper]
    concordant = np.count_nonzero(d > 0)
    discordant = np.count_nonzero(d < 0)
    total = n * (n - 1) / 2
    return float((concordant - discordant) / total)


def kendall_tau_between(a_uids: Sequence[int], b_uids: Sequence[int]) -> float:
    """Kendall tau between two permutations of the same uid set."""
    pos_b = {u: i for i, u in enumerate(b_uids)}
    ranks = np.asarray([pos_b[u] for u in a_uids], dtype=np.float64)
    n = len(ranks)
    if n < 2:
        return 1.0
    diff = ranks[None, :] - ranks[:, None]
    upper = np.triu_indices(n, k=1)
    d = diff[upper]
    concordant = np.count_nonzero(d > 0)
    discordant = np.count_nonzero(d < 0)
    return float((concordant - discordant) / (n * (n - 1) / 2))


def graded_relevance(keys: Sequence[Key], n_grades: int = 4, descending: bool = True) -> dict[int, int]:
    """TREC-style graded relevance derived from latent values.

    The best ``~n/10`` items get the top grade and grades fall off
    geometrically, imitating DL19/DL20 qrel sparsity (most passages grade 0).
    """
    ordered = sorted(keys, key=lambda k: k.latent, reverse=descending)
    n = len(ordered)
    rel: dict[int, int] = {}
    # geometric buckets: top 5% -> n_grades-1, next 10% -> n_grades-2, ...
    bounds = []
    frac = 0.05
    for g in range(n_grades - 1, 0, -1):
        bounds.append((g, frac))
        frac *= 2
    idx = 0
    for g, f in bounds:
        hi = min(n, idx + max(1, int(round(f * n))))
        for k in ordered[idx:hi]:
            rel[k.uid] = g
        idx = hi
    for k in ordered[idx:]:
        rel[k.uid] = 0
    return rel


def dcg(rels: Sequence[float]) -> float:
    return float(sum(r / math.log2(i + 2) for i, r in enumerate(rels)))


def ndcg_at_k(order: Sequence[Key], relevance: Mapping[int, float], k: int = 10) -> float:
    """nDCG@k of a produced order against a graded relevance map."""
    got = [relevance.get(key.uid, 0.0) for key in order[:k]]
    ideal = sorted(relevance.values(), reverse=True)[:k]
    idcg = dcg(ideal)
    if idcg == 0.0:
        return 0.0
    return dcg(got) / idcg


def ndcg_between(order_uids: Sequence[int], gold_uids: Sequence[int], k: int = 10) -> float:
    """nDCG@k of one ranking against another ranking used as a proxy gold.

    Positions in ``gold_uids`` are converted to graded gains (first item
    highest).  Used by the pessimistic (Borda) optimizer to score candidates
    against the consensus gold list.
    """
    n = len(gold_uids)
    gains = {u: float(n - i) for i, u in enumerate(gold_uids)}
    got = [gains.get(u, 0.0) for u in order_uids[:k]]
    ideal = sorted(gains.values(), reverse=True)[:k]
    idcg = dcg(ideal)
    if idcg == 0.0:
        return 0.0
    return dcg(got) / idcg
