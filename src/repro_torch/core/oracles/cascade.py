"""Model-cascade oracle: draft-first probe rounds with uncertainty escalation.

Every probe round runs as a TWO-WAVE submission.  Wave 1 answers the whole
round on a small draft engine (a reduced config from ``configs/registry``,
e.g. stablelm-1.6b); each row's confidence is its logit margin —
``|logit_A − logit_B|`` for compares, the rating gap for scores, the Y/N gap
for inquiries.  Only rows whose margin falls below ``threshold`` escalate to
the large engine in wave 2.  Both waves live inside the SAME round future,
so executor ticks, fairness bounds, and per-plan attribution are unchanged;
the scheduler routes the waves onto per-tier engine lanes
(:meth:`~repro_torch.serving.scheduler.BatchScheduler.submit_cascade_round`).

Billing: the draft wave bills one draft-tier record per logical call at
round begin (payload order); the escalation wave bills large-tier records at
escalation time (slot order) and attributes them back to the owning plan via
the round token's ``extra_records``.  A :class:`~.base.TieredPrices` book
then prices the shared ledger exactly per tier.

Identity anchor: ``threshold=inf`` (or ``draft_engine=None``) collapses to
pure large-model execution — no draft wave, untiered records — and is
byte-identical in BOTH output and ledger to :class:`ModelOracle` on the
large engine.  ``threshold=0`` never escalates (margins are nonnegative), so
zero large-tier probe records are billed.

:class:`SimulatedCascadeOracle` is the calibrated-noise twin (draft answers
from a noisier profile with an explicit Bradley–Terry margin; escalations
answered by the large profile's exact rng streams), giving the fast tier-1
identity tests and the table11 sweep the same contract without a model.

Counterpart of ``src/repro/core/oracles/cascade.py`` (copied; only imports and
cross-references point at the port)."""
from __future__ import annotations

import copy
import math
from typing import Optional, Sequence

import numpy as np

from ..types import Key
from .base import CASCADE_70B, Oracle, PromptCosts, TieredPrices
from .model_oracle import ModelOracle
from .simulated import OracleProfile, REASONING, SimulatedOracle

# Calibration for a small draft judge: noisier scores, flatter compare
# logits (higher Bradley–Terry temperature), no memorization.  The compare
# temperature is the load-bearing number: at 0.45 the draft's CONFIDENT
# answers (high |logit margin|) are usually right even though its overall
# accuracy trails the large profile — which is exactly the regime where
# margin-gated escalation pays (benchmarks/table11_cascade.py).
DRAFT_1p6B = OracleProfile(
    name="draft-1.6b", memorization=0.0, score_noise=0.95, score_squash=0.40,
    compare_temp=0.45, listwise_noise=0.60, membership_rate=0.10,
    invalid_rate=0.0,
)


def probe_margin(kind: str, logits) -> float:
    """Uncertainty of ONE answered probe from its last-position logits:
    the gap between the two tokens the read-out would compare."""
    from ...serving.engine import (TOK_A, TOK_B, TOK_HI, TOK_LO, TOK_NO,
                                   TOK_YES)
    l = np.asarray(logits)
    if kind == "compare":
        return float(abs(l[TOK_A] - l[TOK_B]))
    if kind == "inquire":
        return float(abs(l[TOK_YES] - l[TOK_NO]))
    return float(abs(l[TOK_HI] - l[TOK_LO]))  # score / rank rating gap


class _CascadeToken:
    """Deferred-round token wrapping the inner (kind, future, meta, plan)
    token with the escalation wave's large-tier records, which the executor
    folds into the owning plan's attribution after finish."""

    __slots__ = ("inner", "extra_records")

    def __init__(self, inner, extra_records: list):
        self.inner = inner
        self.extra_records = extra_records


class CascadeOracle(ModelOracle):
    """ModelOracle over a (draft, large) engine pair.

    ``engine`` is the LARGE engine (the quality anchor); ``draft_engine``
    the small one.  ``threshold`` is the escalation margin — calibrate with
    :meth:`calibrate_threshold` or sweep it via the optimizer's ladder
    (:meth:`at_threshold` views share this oracle's ledger and engines).

    A SemanticMemo is NOT consulted in cascade mode (memo'd values are
    large-model answers; replaying them for a draft-priced round would
    corrupt tier attribution) — attach one only at ``threshold=inf``.
    """

    def __init__(self, engine, draft_engine=None, threshold: float = math.inf,
                 prices: TieredPrices = CASCADE_70B,
                 costs: Optional[PromptCosts] = None,
                 judge_rationale_tokens: int = 0, scheduler=None):
        super().__init__(engine, prices=prices, costs=costs,
                         judge_rationale_tokens=judge_rationale_tokens,
                         scheduler=scheduler)
        self.draft_engine = draft_engine
        self.threshold = float(threshold)

    @property
    def _cascading(self) -> bool:
        return self.draft_engine is not None and self.threshold != math.inf

    def at_threshold(self, threshold: float) -> "CascadeOracle":
        """A rung view at a different escalation threshold sharing THIS
        oracle's ledger, engines, scheduler, and tenant — the optimizer
        pilots (path × threshold) candidates through these, so one budget
        governs the whole ladder."""
        clone = copy.copy(self)
        clone.threshold = float(threshold)
        return clone

    # ---- two-wave round core --------------------------------------------
    def _bill_draft_round(self, kind: str, payload, criteria: str) -> list:
        """Bill the draft wave (one draft-tier record per logical call,
        payload order) and return the round's prompts — the SAME prompts
        both engines answer (pure string templates over key text)."""
        prompts: list = []
        if kind in ("compare", "score_each", "inquire"):
            for item in payload:
                self._charge_probe(kind, item, tier="draft")
                prompts.append(self._probe_prompt(kind, item, criteria))
        else:  # score_batches / rank_windows: one record per batch
            bill_kind = "score" if kind == "score_batches" else "rank"
            prefix = (self.costs.score_prefix if kind == "score_batches"
                      else self.costs.rank_prefix)
            per_key = (self.costs.score_out_per_key if kind == "score_batches"
                       else self.costs.rank_out_per_key)
            for b in payload:
                inp = prefix + sum(self._real_tokens(k.text) for k in b)
                self.ledger.charge(bill_kind, inp, per_key * len(b),
                                   n_keys=len(b), tier="draft")
                prompts.extend(self.engine.score_parts(k.text, criteria)
                               for k in b)
        return prompts

    def _bill_escalations(self, kind: str, payload, esc: Sequence[int]) -> None:
        """Bill the escalation wave: large-tier records in slot order.  For
        the batch kinds, one record per batch that escalated ≥1 key (n_keys
        and token counts cover ONLY the escalated keys)."""
        if kind in ("compare", "score_each", "inquire"):
            for i in esc:
                self._charge_probe(kind, payload[i], tier="large")
            return
        bill_kind = "score" if kind == "score_batches" else "rank"
        prefix = (self.costs.score_prefix if kind == "score_batches"
                  else self.costs.rank_prefix)
        per_key = (self.costs.score_out_per_key if kind == "score_batches"
                   else self.costs.rank_out_per_key)
        esc_set = set(esc)
        flat = 0
        for b in payload:
            keys = [k for j, k in enumerate(b, start=flat) if j in esc_set]
            flat += len(b)
            if keys:
                inp = prefix + sum(self._real_tokens(k.text) for k in keys)
                self.ledger.charge(bill_kind, inp, per_key * len(keys),
                                   n_keys=len(keys), tier="large")

    def _cascade_round(self, kind: str, payload, criteria: str) -> list:
        """Synchronous two-wave execution; returns final per-slot logits
        (ledger order: all draft records, then escalations in slot order —
        identical to the deferred path through submit_cascade_round)."""
        prompts = self._bill_draft_round(kind, payload, criteria)
        final = list(self.draft_engine.submit_probes(prompts))
        esc = [i for i, l in enumerate(final)
               if probe_margin(kind, l) < self.threshold]
        self._bill_escalations(kind, payload, esc)
        if esc:
            large = self.engine.submit_probes([prompts[i] for i in esc])
            for j, i in enumerate(esc):
                final[i] = large[j]
        return final

    def calibrate_threshold(self, keys: Sequence[Key], criteria: str,
                            quantile: float = 0.5, kind: str = "compare",
                            max_probes: int = 32) -> float:
        """Set ``threshold`` at a quantile of the draft margins observed on
        a sample: ``quantile=0.5`` escalates roughly half the probes.  The
        calibration probes run (and are billed) as a draft-tier round."""
        if self.draft_engine is None:
            raise ValueError("calibration needs a draft engine")
        if kind == "compare":
            payload = [(keys[i], keys[i + 1])
                       for i in range(len(keys) - 1)][:max_probes]
        else:
            payload = list(keys)[:max_probes]
        prompts = self._bill_draft_round(kind, payload, criteria)
        logits = self.draft_engine.submit_probes(prompts)
        margins = [probe_margin(kind, l) for l in logits]
        self.threshold = float(np.quantile(np.asarray(margins), quantile))
        return self.threshold

    # ---- synchronous round verbs ----------------------------------------
    def compare_batch(self, pairs, criteria: str) -> list[int]:
        if not self._cascading or not pairs:
            return super().compare_batch(pairs, criteria)
        from ...serving.engine import read_compare
        return [read_compare(l)
                for l in self._cascade_round("compare", pairs, criteria)]

    def compare(self, a: Key, b: Key, criteria: str) -> int:
        if not self._cascading:
            return super().compare(a, b, criteria)
        return self.compare_batch([(a, b)], criteria)[0]

    def score_each(self, keys: Sequence[Key], criteria: str) -> list[float]:
        if not self._cascading or not keys:
            return super().score_each(keys, criteria)
        from ...serving.engine import read_score
        return [read_score(l)
                for l in self._cascade_round("score_each", keys, criteria)]

    def score_batches(self, batches, criteria: str) -> list[list[float]]:
        if not self._cascading or not any(len(b) for b in batches):
            return super().score_batches(batches, criteria)
        from ...serving.engine import read_score
        logits = self._cascade_round("score_batches", batches, criteria)
        return self._split_rounds([read_score(l) for l in logits],
                                  [list(b) for b in batches], rank=False)

    def score_batch(self, keys: Sequence[Key], criteria: str) -> list[float]:
        if not self._cascading:
            return super().score_batch(keys, criteria)
        return self.score_batches([list(keys)], criteria)[0]

    def rank_batches(self, batches, criteria: str):
        if not self._cascading or not any(len(b) for b in batches):
            return super().rank_batches(batches, criteria)
        from ...serving.engine import read_score
        logits = self._cascade_round("rank_windows", batches, criteria)
        return self._split_rounds([read_score(l) for l in logits],
                                  [list(b) for b in batches], rank=True)

    def rank_batch(self, keys: Sequence[Key], criteria: str) -> list[Key]:
        if not self._cascading:
            return super().rank_batch(keys, criteria)
        return self.rank_batches([list(keys)], criteria)[0]

    def inquire_batch(self, keys: Sequence[Key], criteria: str) -> list[bool]:
        if not self._cascading or not keys:
            return super().inquire_batch(keys, criteria)
        from ...serving.engine import read_yes_no
        return [read_yes_no(l)
                for l in self._cascade_round("inquire", keys, criteria)]

    def inquire(self, key: Key, criteria: str) -> bool:
        if not self._cascading:
            return super().inquire(key, criteria)
        return self.inquire_batch([key], criteria)[0]

    # ---- deferred rounds (probe-plan executor) ---------------------------
    def preview_round_prompts(self, kind: str, payload, criteria: str) -> list:
        if not self._cascading:
            return super().preview_round_prompts(kind, payload, criteria)
        # wave 1 runs on the draft engine: warming the LARGE engine's
        # prefix regions for prompts that may never escalate is waste
        return []

    def begin_probe_round(self, kind: str, payload, criteria: str, sink):
        if not self._cascading:
            return super().begin_probe_round(kind, payload, criteria, sink)
        if not hasattr(sink, "submit_cascade_round"):
            raise TypeError("cascade rounds need a BatchScheduler sink with "
                            "submit_cascade_round (two-lane step loop)")
        payload = list(payload)
        prompts = self._bill_draft_round(kind, payload, criteria)
        extra: list = []

        def escalate(draft_logits: dict) -> set:
            """Scheduler callback at the end of wave 1: pick + bill the
            escalations; records land in ``extra`` for plan attribution."""
            esc = [i for i in sorted(draft_logits)
                   if probe_margin(kind, draft_logits[i]) < self.threshold]
            snap = len(self.ledger.records)
            self._bill_escalations(kind, payload, esc)
            extra.extend(self.ledger.records[snap:])
            return set(esc)

        kw = {} if self.tenant == "default" else {"tenant": self.tenant}
        fut = sink.submit_cascade_round(prompts, escalate, **kw)
        meta = ([list(b) for b in payload]
                if kind in ("score_batches", "rank_windows") else None)
        return _CascadeToken((kind, fut, meta, None), extra)

    def finish_probe_round(self, token, sink):
        if isinstance(token, _CascadeToken):
            token = token.inner
        return super().finish_probe_round(token, sink)


class SimulatedCascadeOracle(Oracle):
    """Calibrated-noise twin of :class:`CascadeOracle`: a noisy draft
    profile answers wave 1 with an explicit margin (the Bradley–Terry
    logistic delta for compares, |rating| for scores), and escalations are
    answered by the large profile's exact rng streams — so at
    ``threshold=inf`` every verb delegates to a plain
    :class:`SimulatedOracle` on the large profile, byte-identical in
    answers AND ledger records.  Cascade-mode draft waves never fail
    structurally (logit-probe semantics); passthrough keeps the large
    profile's failure model."""

    def __init__(self, draft: OracleProfile = DRAFT_1p6B,
                 large: OracleProfile = REASONING,
                 threshold: float = math.inf,
                 prices: TieredPrices = CASCADE_70B,
                 costs: Optional[PromptCosts] = None):
        super().__init__(prices=prices, costs=costs)
        self._draft = SimulatedOracle(draft, prices=prices, costs=costs)
        self._large = SimulatedOracle(large, prices=prices, costs=costs)
        # one shared ledger: passthrough delegation bills through _large
        self._draft.ledger = self.ledger
        self._large.ledger = self.ledger
        self.threshold = float(threshold)

    @property
    def _cascading(self) -> bool:
        return self.threshold != math.inf

    def at_threshold(self, threshold: float) -> "SimulatedCascadeOracle":
        clone = copy.copy(self)
        clone.threshold = float(threshold)
        return clone

    # ---- draft-wave answers with explicit margins ------------------------
    def _draft_compare_delta(self, a: Key, b: Key, criteria: str) -> float:
        """Signed Bradley–Terry delta w.r.t. ``a``: Δlatent/τ_draft plus
        standard-logistic noise, so P(delta>0) = σ(Δ/τ) exactly; |delta|
        is the draft's confidence margin."""
        lo, hi = (a, b) if a.uid <= b.uid else (b, a)
        rng = self._draft._rng("compare", lo.uid, hi.uid, criteria)
        u = min(max(rng.random(), 1e-12), 1.0 - 1e-12)
        noise = math.log(u) - math.log1p(-u)
        delta = ((hi.latent - lo.latent) / self._draft.profile.compare_temp
                 + noise)
        return delta if (a is hi or a.uid == hi.uid) else -delta

    def _cascade_score_batches(self, batches, criteria: str,
                               bill: str) -> list[list[float]]:
        """Two-wave scoring over batches (draft values + |rating| margins,
        then per-batch escalation of low-margin keys to the large profile);
        billing order matches CascadeOracle: all draft records, then
        escalations in batch order."""
        charge = self._charge_score if bill == "score" else self._charge_rank
        batches = [list(b) for b in batches]
        vals_all = []
        for b in batches:
            charge(b, tier="draft")
            vals_all.append([self._draft._score_value(k, criteria, len(b))
                             for k in b])
        for b, vals in zip(batches, vals_all):
            esc = [i for i, v in enumerate(vals) if abs(v) < self.threshold]
            if esc:
                charge([b[i] for i in esc], tier="large")
                for i in esc:
                    vals[i] = self._large._score_value(b[i], criteria, len(b))
        return vals_all

    # ---- verbs -----------------------------------------------------------
    def compare(self, a: Key, b: Key, criteria: str) -> int:
        if not self._cascading:
            return self._large.compare(a, b, criteria)
        return self.compare_batch([(a, b)], criteria)[0]

    def compare_batch(self, pairs, criteria: str) -> list[int]:
        if not self._cascading:
            return self._large.compare_batch(pairs, criteria)
        deltas = []
        for a, b in pairs:
            self._charge_compare(a, b, tier="draft")
            deltas.append(self._draft_compare_delta(a, b, criteria))
        out = []
        for (a, b), d in zip(pairs, deltas):
            if abs(d) < self.threshold:
                self._charge_compare(a, b, tier="large")
                out.append(self._large._compare_value(a, b, criteria))
            else:
                out.append(1 if d > 0 else -1)
        return out

    def score_batch(self, keys: Sequence[Key], criteria: str) -> list[float]:
        if not self._cascading:
            return self._large.score_batch(keys, criteria)
        return self._cascade_score_batches([list(keys)], criteria, "score")[0]

    def score_each(self, keys: Sequence[Key], criteria: str) -> list[float]:
        if not self._cascading:
            return self._large.score_each(keys, criteria)
        out = self._cascade_score_batches([[k] for k in keys], criteria,
                                          "score")
        return [v[0] for v in out]

    def score_batches(self, batches, criteria: str) -> list[list[float]]:
        if not self._cascading:
            return self._large.score_batches(batches, criteria)
        return self._cascade_score_batches(batches, criteria, "score")

    def rank_batch(self, keys: Sequence[Key], criteria: str) -> list[Key]:
        if not self._cascading:
            return self._large.rank_batch(keys, criteria)
        return self.rank_batches([list(keys)], criteria)[0]

    def rank_batches(self, batches, criteria: str):
        if not self._cascading:
            return self._large.rank_batches(batches, criteria)
        batches = [list(b) for b in batches]
        vals = self._cascade_score_batches(batches, criteria, "rank")
        out = []
        for b, v in zip(batches, vals):
            order = np.argsort(np.asarray(v), kind="stable")
            out.append([b[i] for i in order])
        return out

    def inquire(self, key: Key, criteria: str) -> bool:
        if not self._cascading:
            return self._large.inquire(key, criteria)
        return self.inquire_batch([key], criteria)[0]

    def inquire_batch(self, keys: Sequence[Key], criteria: str) -> list[bool]:
        if not self._cascading:
            return self._large.inquire_batch(keys, criteria)
        rate = self._draft.profile.membership_rate
        drafts = []
        for k in keys:
            self._charge_inquire(k, tier="draft")
            u = self._draft._rng("inquire", k.uid, criteria).random()
            drafts.append((bool(u < rate), abs(u - rate)))
        out = []
        for k, (ans, margin) in zip(keys, drafts):
            if margin < self.threshold:
                self._charge_inquire(k, tier="large")
                out.append(self._large._inquire_value(k, criteria))
            else:
                out.append(ans)
        return out

    def judge(self, keys: Sequence[Key], criteria: str,
              candidates: Sequence[Sequence[Key]]) -> int:
        # judging stays on the large profile in both modes (selection-time
        # quality probe, untiered like single-model execution)
        return self._large.judge(keys, criteria, candidates)

    def try_rank_batches(self, batches, criteria: str) -> list:
        if not self._cascading:
            return self._large.try_rank_batches(batches, criteria)
        return super().try_rank_batches(batches, criteria)

    def try_score_batches(self, batches, criteria: str) -> list:
        if not self._cascading:
            return self._large.try_score_batches(batches, criteria)
        return super().try_score_batches(batches, criteria)

    def try_score_each(self, keys: Sequence[Key], criteria: str) -> list:
        if not self._cascading:
            return self._large.try_score_each(keys, criteria)
        return super().try_score_each(keys, criteria)
