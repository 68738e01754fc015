"""Simulated semantic oracles.

:class:`SimulatedOracle` reproduces the paper's empirical regime with
*temperature-0 semantics*: every response is a deterministic function of the
prompt (key uids + criteria + call kind), drawn from calibrated noise models:

 * pointwise scores   — latent value + miscalibration + Gaussian noise whose σ
   shrinks with the dataset's *memorization* level (factual keys are recalled,
   Sec. 5.2) and grows with listwise batch size (batch degradation, Alg. 1),
 * pairwise compares  — Bradley–Terry: P(correct) = σ((Δlatent)/τ),
 * listwise rankings  — noisy-score sort with batch-size-dependent σ and a
   primacy bias, plus a structural-failure probability that grows with batch
   size (the JSON-error mode the paper observed on Llama),
 * membership inquiry — per-key Bernoulli(membership_rate),
 * LLM-as-Judge       — true sample quality + noise ∝ prompt length
   (the "lost-in-the-middle" long-context degradation of Sec. 6.2).

:class:`ExactOracle` is the noise-free limit used by property tests.

Counterpart of ``src/repro/core/oracles/simulated.py`` (copied; only imports and
cross-references point at the port)."""
from __future__ import annotations

import hashlib
import math
from dataclasses import dataclass
from typing import Optional, Sequence

import numpy as np

from ..metrics import kendall_tau
from ..types import InvalidOutputError, Key
from .base import LLAMA70B, Oracle, PriceSheet, PromptCosts


@dataclass(frozen=True)
class OracleProfile:
    """Calibration of one (model × dataset-family) pair."""

    name: str = "default"
    # --- pointwise / value-based ---
    memorization: float = 0.0      # 0..1; 1 => key values memorized verbatim
    score_noise: float = 0.35      # σ of pointwise score noise (latents ~ N(0,1))
    score_squash: float = 0.0      # 0..1 miscalibration: squashes score range
    batch_degradation: float = 0.20  # extra σ per log2(batch)
    # --- pairwise ---
    compare_temp: float = 0.25     # Bradley-Terry τ (lower = more reliable)
    # --- listwise ---
    listwise_noise: float = 0.30
    listwise_primacy: float = 0.05  # bias toward presented order
    invalid_rate: float = 0.02      # structural failure slope vs log2(m)
    # --- membership / judge ---
    membership_rate: float = 0.1
    judge_noise_per_ktok: float = 0.05
    seed: int = 0


# Calibrations for the two qualitative regimes in the paper.
FACTUAL = OracleProfile(
    name="factual", memorization=0.95, score_noise=0.08, compare_temp=0.55,
    listwise_noise=0.45, membership_rate=1.0, invalid_rate=0.03,
)
REASONING = OracleProfile(
    name="reasoning", memorization=0.05, score_noise=0.85, score_squash=0.55,
    compare_temp=0.16, listwise_noise=0.22, membership_rate=0.10,
    judge_noise_per_ktok=0.09,
)
SENTIMENT = OracleProfile(
    name="sentiment", memorization=0.30, score_noise=0.30, score_squash=0.2,
    compare_temp=0.22, listwise_noise=0.25, membership_rate=0.25,
)


def _hash_seed(*parts) -> int:
    h = hashlib.blake2b(repr(parts).encode(), digest_size=8)
    return int.from_bytes(h.digest(), "little")


class SimulatedOracle(Oracle):
    def __init__(self, profile: OracleProfile = REASONING,
                 prices: PriceSheet = LLAMA70B,
                 costs: Optional[PromptCosts] = None):
        super().__init__(prices=prices, costs=costs)
        self.profile = profile

    # -- deterministic noise (temperature-0 semantics) ----------------------
    def _rng(self, *parts) -> np.random.Generator:
        return np.random.default_rng(_hash_seed(self.profile.seed, *parts))

    def _point_sigma(self, m: int) -> float:
        p = self.profile
        base = p.score_noise * (1.0 - 0.9 * p.memorization)
        return base * (1.0 + p.batch_degradation * math.log2(max(m, 1)))

    def _squash(self, z: float) -> float:
        # miscalibration: compress dynamic range through tanh
        s = self.profile.score_squash
        return (1 - s) * z + s * math.tanh(z)

    # -- unbilled response values -------------------------------------------
    # Each verb = one _charge_* + one _*_value.  The value methods carry the
    # whole noise model and draw from the same rng streams, so a different
    # biller (the cascade oracle's escalation wave) reproduces this oracle's
    # answers byte-for-byte without double-billing.
    def _score_value(self, k: Key, criteria: str, m: int) -> float:
        rng = self._rng("score", k.uid, criteria, m)
        return self._squash(k.latent) + self._point_sigma(m) * rng.standard_normal()

    def _compare_value(self, a: Key, b: Key, criteria: str) -> int:
        # antisymmetric by canonical pair ordering
        lo, hi = (a, b) if a.uid <= b.uid else (b, a)
        rng = self._rng("compare", lo.uid, hi.uid, criteria)
        p_hi_wins = 1.0 / (1.0 + math.exp(-(hi.latent - lo.latent) / self.profile.compare_temp))
        hi_wins = rng.random() < p_hi_wins
        if hi_wins:
            return 1 if a is hi or a.uid == hi.uid else -1
        return 1 if a.uid == lo.uid else -1

    def _rank_values(self, keys: Sequence[Key], criteria: str) -> list[float]:
        p = self.profile
        m = len(keys)
        sigma = p.listwise_noise * (1.0 + p.batch_degradation * math.log2(max(m, 1)))
        uids = tuple(k.uid for k in keys)
        noisy = []
        for i, k in enumerate(keys):
            rng = self._rng("rank", uids, k.uid, criteria)
            val = k.latent + sigma * rng.standard_normal()
            val += p.listwise_primacy * (i / max(m - 1, 1))  # primacy bias
            noisy.append(val)
        return noisy

    def _inquire_value(self, key: Key, criteria: str) -> bool:
        rng = self._rng("inquire", key.uid, criteria)
        return bool(rng.random() < self.profile.membership_rate)

    # -- verbs ---------------------------------------------------------------
    def score_batch(self, keys: Sequence[Key], criteria: str) -> list[float]:
        self._charge_score(keys)
        m = len(keys)
        self._maybe_invalid("score", keys, criteria, m)
        return [self._score_value(k, criteria, m) for k in keys]

    def compare(self, a: Key, b: Key, criteria: str) -> int:
        self._charge_compare(a, b)
        return self._compare_value(a, b, criteria)

    def rank_batch(self, keys: Sequence[Key], criteria: str) -> list[Key]:
        self._charge_rank(keys)
        m = len(keys)
        self._maybe_invalid("rank", keys, criteria, m)
        order = np.argsort(np.asarray(self._rank_values(keys, criteria)),
                           kind="stable")
        return [keys[i] for i in order]  # ascending criteria (worst -> best)

    def inquire(self, key: Key, criteria: str) -> bool:
        self._charge_inquire(key)
        return self._inquire_value(key, criteria)

    def judge(self, keys: Sequence[Key], criteria: str,
              candidates: Sequence[Sequence[Key]]) -> int:
        inp_tokens = self._charge_judge(keys, candidates)
        p = self.profile
        sigma = p.judge_noise_per_ktok * (inp_tokens / 1000.0)
        best_i, best_v = 0, -math.inf
        for i, cand in enumerate(candidates):
            true_quality = kendall_tau(list(cand))  # vs latent ground truth
            rng = self._rng("judge", tuple(k.uid for k in cand), criteria, i)
            v = true_quality + sigma * rng.standard_normal()
            if v > best_v:
                best_i, best_v = i, v
        return best_i

    # -- structural failures ---------------------------------------------------
    def _maybe_invalid(self, kind: str, keys: Sequence[Key], criteria: str, m: int) -> None:
        if m < 4:
            return
        p_bad = min(0.9, self.profile.invalid_rate * max(0.0, math.log2(m) - 1.0))
        rng = self._rng("invalid", kind, tuple(k.uid for k in keys), criteria)
        if rng.random() < p_bad:
            raise InvalidOutputError(f"simulated malformed {kind} output (m={m})")


class ExactOracle(Oracle):
    """Noise-free oracle: property tests demand perfectly sorted output."""

    def score_batch(self, keys: Sequence[Key], criteria: str) -> list[float]:
        self._charge_score(keys)
        return [k.latent for k in keys]

    def compare(self, a: Key, b: Key, criteria: str) -> int:
        self._charge_compare(a, b)
        if a.latent == b.latent:
            return 1 if a.uid > b.uid else -1  # deterministic tie-break
        return 1 if a.latent > b.latent else -1

    def rank_batch(self, keys: Sequence[Key], criteria: str) -> list[Key]:
        self._charge_rank(keys)
        return sorted(keys, key=lambda k: (k.latent, k.uid))

    def inquire(self, key: Key, criteria: str) -> bool:
        self._charge_inquire(key)
        return True

    def judge(self, keys: Sequence[Key], criteria: str,
              candidates: Sequence[Sequence[Key]]) -> int:
        self._charge_judge(keys, candidates)
        scores = [kendall_tau(list(c)) for c in candidates]
        return int(np.argmax(scores))


class FlakyOracle(ExactOracle):
    """Exact oracle whose listwise calls fail deterministically above a batch
    size threshold — used to test Alg. 1's fallback and batch-split retry."""

    def __init__(self, fail_above: int = 8, **kw):
        super().__init__(**kw)
        self.fail_above = fail_above

    def score_batch(self, keys, criteria):
        if len(keys) > self.fail_above:
            self._charge_score(keys)
            raise InvalidOutputError(f"batch {len(keys)} > {self.fail_above}")
        return super().score_batch(keys, criteria)

    def rank_batch(self, keys, criteria):
        if len(keys) > self.fail_above:
            self._charge_rank(keys)
            raise InvalidOutputError(f"batch {len(keys)} > {self.fail_above}")
        return super().rank_batch(keys, criteria)
