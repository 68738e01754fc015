"""Synthetic benchmark families mirroring the paper's datasets.

Each generator returns a :class:`RankingTask` = (keys with hidden latents,
criteria text, oracle profile, metric kind).  The latent is what the paper's
benchmarks hide (masked player height, masked population, qrel relevance):

 * ``nba_heights`` / ``world_population`` — factual keys, fully memorized
   (membership 100%) => pointwise excels (paper Sec. 4.2 / 6.2),
 * ``passages`` — DL19/DL20-like: long texts, low membership, comparisons
   reliable but scores uncalibrated => comparison-based excels,
 * ``tweets`` — TweetEval-like short sentiment texts, mixed membership,
 * ``movie_reviews`` — SembenchMovie-like medium reviews.

Text lengths matter: they drive token billing and judge context degradation.

Counterpart of ``src/repro/core/datasets.py`` (copied; only imports and
cross-references point at the port)."""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np

from .oracles.simulated import (FACTUAL, REASONING, SENTIMENT, OracleProfile)
from .types import Key


@dataclass
class RankingTask:
    name: str
    keys: list[Key]
    criteria: str
    profile: OracleProfile
    descending: bool = True
    limit: Optional[int] = None
    metric: str = "kendall"     # "kendall" | "ndcg"
    queries: int = 1            # number of sub-queries this family represents


def _mk_keys(rng: np.random.Generator, n: int, latents: np.ndarray,
             words_lo: int, words_hi: int, stem: str) -> list[Key]:
    keys = []
    for i in range(n):
        n_words = int(rng.integers(words_lo, words_hi + 1))
        words = rng.integers(0, 50_000, size=n_words)
        text = f"{stem}-{i} " + " ".join(f"w{w}" for w in words)
        keys.append(Key(uid=i, text=text, latent=float(latents[i])))
    return keys


def nba_heights(n: int = 200, seed: int = 0) -> RankingTask:
    rng = np.random.default_rng(seed)
    z = rng.standard_normal(n)  # standardized heights
    keys = _mk_keys(rng, n, z, 2, 4, "player")
    return RankingTask("nba", keys, "player height", FACTUAL,
                       descending=True, limit=None, metric="kendall")


def world_population(n: int = 200, seed: int = 1) -> RankingTask:
    rng = np.random.default_rng(seed)
    z = np.sort(rng.standard_normal(n) * 1.4)[::-1].copy()
    rng.shuffle(z)
    keys = _mk_keys(rng, n, z, 1, 3, "region")
    return RankingTask("population", keys, "population of the region", FACTUAL,
                       descending=True, limit=None, metric="kendall")


def passages(n: int = 100, seed: int = 2, query: str = "define bmt medical") -> RankingTask:
    rng = np.random.default_rng(seed)
    # BM25-retrieved top-100: a few highly relevant, long tail of marginal
    z = rng.gamma(shape=1.3, scale=0.8, size=n)
    keys = _mk_keys(rng, n, z, 120, 400, "passage")
    return RankingTask(f"dl-{query}", keys, f"relevance to query: {query}",
                       REASONING, descending=True, limit=10, metric="ndcg")


def tweets(n: int = 120, seed: int = 3, sentiment: str = "positivity") -> RankingTask:
    rng = np.random.default_rng(seed)
    z = rng.standard_normal(n)
    keys = _mk_keys(rng, n, z, 8, 40, "tweet")
    return RankingTask(f"tweets-{sentiment}", keys, f"intensity of {sentiment}",
                       SENTIMENT, descending=True, limit=10, metric="ndcg")


def movie_reviews(n: int = 150, seed: int = 4) -> RankingTask:
    rng = np.random.default_rng(seed)
    z = rng.standard_normal(n)
    profile = OracleProfile(
        name="movie", memorization=0.25, score_noise=0.6, score_squash=0.4,
        compare_temp=0.2, listwise_noise=0.25, membership_rate=0.25,
    )
    keys = _mk_keys(rng, n, z, 60, 180, "review")
    return RankingTask("movie-q9", keys, "degree of positivity", profile,
                       descending=True, limit=10, metric="ndcg")


def benchmark_suite(seed: int = 0) -> list[RankingTask]:
    """The Fig. 3 benchmark families (one task per family; the multi-query
    DL/Tweet families are expanded by benchmarks that need per-query spread)."""
    return [
        world_population(seed=seed + 1),
        tweets(seed=seed + 3),
        movie_reviews(seed=seed + 4),
        passages(seed=seed + 2),
    ]


def dl_queries(n_queries: int = 8, n: int = 100, seed: int = 10) -> list[RankingTask]:
    """A DL20-like multi-query family.

    Queries are heterogeneous (paper Fig. 2: the per-query optimal algorithm
    varies wildly within one benchmark): each query draws its own oracle
    calibration — some are score-friendly (well-calibrated pointwise), some
    comparison-friendly, some listwise-hostile.
    """
    rng = np.random.default_rng(seed)
    out = []
    for q in range(n_queries):
        t = passages(n=n, seed=seed + q, query=f"query-{q}")
        prof = OracleProfile(
            name=f"dl-q{q}",
            memorization=float(rng.uniform(0.0, 0.3)),
            score_noise=float(rng.uniform(0.3, 1.2)),
            score_squash=float(rng.uniform(0.2, 0.8)),
            compare_temp=float(rng.uniform(0.1, 0.6)),
            listwise_noise=float(rng.uniform(0.1, 0.6)),
            membership_rate=float(rng.uniform(0.0, 0.25)),
            judge_noise_per_ktok=0.09,
            seed=seed + q,
        )
        out.append(RankingTask(t.name, t.keys, t.criteria, prof,
                               descending=True, limit=t.limit, metric="ndcg"))
    return out
