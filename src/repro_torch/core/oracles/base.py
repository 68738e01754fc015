"""Oracle interface + token/dollar accounting.

Every access path is written against :class:`Oracle`; the paper's hosted-API
assumption becomes an interface with three backends:

 * :class:`~repro_torch.core.oracles.simulated.SimulatedOracle` — calibrated noise,
   used by benchmarks to reproduce the paper's empirical regime,
 * :class:`~repro_torch.core.oracles.simulated.ExactOracle` — noise-free, used by
   property tests (a perfect comparator must yield a perfectly sorted list),
 * :class:`~repro_torch.core.oracles.model_oracle.ModelOracle` — real PyTorch forward
   passes through the serving engine (``repro_torch.serving``).

All billing flows through :class:`TokenLedger`, so Table-1 / Fig-1 style
call-count and dollar accounting is exact and identical across backends.

Counterpart of ``src/repro/core/oracles/base.py`` (copied; only imports and
cross-references point at the port)."""
from __future__ import annotations

import abc
from dataclasses import dataclass
from typing import NamedTuple, Optional, Sequence

from ..types import InvalidOutputError, Key


class PromptParts(NamedTuple):
    """Structured probe prompt: ``prefix`` is the block shared by every call
    of a round (instructions + criteria, plus the pivot in comparison
    rounds); ``suffix`` carries the per-key payload.  The logical prompt is
    the concatenation — backends that don't exploit structure just join the
    parts — but the pair form lets the serving layer prefill the shared
    prefix once per round and reuse its KV (ServeEngine's prefix-KV cache).
    Billing is a function of the logical prompt only, so structuring never
    changes the ledger."""

    prefix: str
    suffix: str

    @property
    def text(self) -> str:
        return self.prefix + self.suffix


@dataclass(frozen=True)
class PriceSheet:
    """$ per million tokens, mirroring per-token API billing."""

    input_per_mtok: float = 0.90
    output_per_mtok: float = 0.90
    name: str = "llama3.1-70b"

    def cost(self, input_tokens: int, output_tokens: int) -> float:
        return (input_tokens * self.input_per_mtok + output_tokens * self.output_per_mtok) / 1e6


LLAMA70B = PriceSheet(0.90, 0.90, "llama3.1-70b")
LLAMA405B = PriceSheet(8.00, 8.00, "llama3.1-405b")
GPT41 = PriceSheet(2.00, 8.00, "gpt-4.1")
STABLELM2 = PriceSheet(0.07, 0.07, "stablelm2-1.6b")


@dataclass(frozen=True)
class TieredPrices:
    """Per-tier price book for model-cascade execution: records tagged with a
    ``CallRecord.tier`` are priced by that tier's sheet, untiered records
    (``tier == ""``) by ``default``.  A LedgerView prices tier-aware books
    record-by-record, so one shared ledger yields exact per-tier dollars."""

    sheets: tuple[tuple[str, PriceSheet], ...] = ()
    default: PriceSheet = LLAMA70B

    @property
    def name(self) -> str:
        return self.default.name

    def sheet(self, tier: str) -> PriceSheet:
        for t, s in self.sheets:
            if t == tier:
                return s
        return self.default

    def record_cost(self, r: "CallRecord") -> float:
        return self.sheet(r.tier).cost(r.input_tokens, r.output_tokens)

    def cost(self, input_tokens: int, output_tokens: int) -> float:
        """Aggregate fallback (prices untiered token totals at ``default``)."""
        return self.default.cost(input_tokens, output_tokens)


CASCADE_70B = TieredPrices((("draft", STABLELM2), ("large", LLAMA70B)), LLAMA70B)


@dataclass(frozen=True)
class CallRecord:
    kind: str            # "score" | "compare" | "rank" | "inquire" | "judge"
    n_keys: int
    input_tokens: int
    output_tokens: int
    tag: str = ""
    tier: str = ""       # "" (single-model) | "draft" | "large" (cascade)


@dataclass
class LedgerView:
    records: list[CallRecord]

    @property
    def n_calls(self) -> int:
        return len(self.records)

    @property
    def input_tokens(self) -> int:
        return sum(r.input_tokens for r in self.records)

    @property
    def output_tokens(self) -> int:
        return sum(r.output_tokens for r in self.records)

    def cost(self, prices: PriceSheet) -> float:
        record_cost = getattr(prices, "record_cost", None)
        if record_cost is not None:  # tier-aware book: price record-by-record
            return sum(record_cost(r) for r in self.records)
        return prices.cost(self.input_tokens, self.output_tokens)

    def by_kind(self, kind: str) -> "LedgerView":
        return LedgerView([r for r in self.records if r.kind == kind])

    def by_tier(self, tier: str) -> "LedgerView":
        return LedgerView([r for r in self.records if r.tier == tier])


class TokenLedger(LedgerView):
    """Append-only call log with snapshot slicing for per-phase accounting."""

    def __init__(self) -> None:
        super().__init__(records=[])

    def charge(self, kind: str, input_tokens: int, output_tokens: int,
               n_keys: int = 1, tag: str = "", tier: str = "") -> None:
        self.records.append(CallRecord(kind, n_keys, int(input_tokens),
                                       int(output_tokens), tag, tier))

    def snapshot(self) -> int:
        return len(self.records)

    def since(self, snap: int) -> LedgerView:
        return LedgerView(self.records[snap:])

    def reset(self) -> None:
        self.records.clear()


@dataclass
class PromptCosts:
    """Token overheads of the prompt templates (Prompt Blocks 1-5).

    ``*_out`` entries model structured CoT outputs (the paper enables
    chain-of-thought fields in the response JSON schema).
    """

    score_prefix: int = 60       # Prompt Block 1 instructions + criteria
    score_out_per_key: int = 24  # rating + short CoT per key
    compare_prefix: int = 55     # Prompt Block 2
    compare_out: int = 30        # verdict + CoT
    rank_prefix: int = 60        # Prompt Block 3
    rank_out_per_key: int = 10   # permutation entry + brief CoT share
    inquire_prefix: int = 45     # Prompt Block 4
    inquire_out: int = 25
    judge_prefix: int = 90       # Prompt Block 5
    judge_out: int = 120


class Oracle(abc.ABC):
    """Semantic black box exposed through standard generation-API verbs."""

    def __init__(self, prices: PriceSheet = LLAMA70B, costs: Optional[PromptCosts] = None):
        self.ledger = TokenLedger()
        self.prices = prices
        self.costs = costs or PromptCosts()
        # Tier stamped on every record this oracle bills ("" = single-model).
        # Cascade oracles flip this per wave; see core/oracles/cascade.py.
        self.bill_tier = ""

    # ---- verbs -----------------------------------------------------------
    @abc.abstractmethod
    def score_batch(self, keys: Sequence[Key], criteria: str) -> list[float]:
        """Value-based: one float per key (higher = larger under criteria).

        ``len(keys) == 1`` is the pointwise path; larger batches are the
        external-pointwise path.  May raise InvalidOutputError.
        """

    @abc.abstractmethod
    def compare(self, a: Key, b: Key, criteria: str) -> int:
        """Comparison-based: +1 if ``a`` ranks above ``b`` under criteria
        (i.e. a's criteria value is larger), else -1."""

    @abc.abstractmethod
    def rank_batch(self, keys: Sequence[Key], criteria: str) -> list[Key]:
        """Listwise: permutation of ``keys`` in ascending criteria order
        (worst-to-best, following Prompt Block 3).  May raise
        InvalidOutputError."""

    @abc.abstractmethod
    def inquire(self, key: Key, criteria: str) -> bool:
        """Membership-inference Inquiry Prompt (Prompt Block 4)."""

    @abc.abstractmethod
    def judge(self, keys: Sequence[Key], criteria: str,
              candidates: Sequence[Sequence[Key]]) -> int:
        """LLM-as-Judge (Prompt Block 5): index of the best candidate ranking."""

    # ---- round (batch) verbs --------------------------------------------
    # Access paths are written against *rounds of independent calls*: at each
    # step they hand the oracle every call whose inputs are already known and
    # that no other call in the set depends on.  The defaults below execute
    # a round as a sequential loop over the point verbs, so results and
    # ledger records are identical call-for-call; ModelOracle overrides them
    # to execute one round as ONE padded serving submission (shared-prefix
    # prefill amortization — the batching economics of Sec. 4) while still
    # billing N logical calls, matching the ``rank_batches`` convention.

    def rank_batches(self, batches: Sequence[Sequence[Key]],
                     criteria: str) -> list[list[Key]]:
        """Batched listwise ranking — the paper's parallel run generation
        (Alg. 4 Phase 1).  Default: sequential loop; the ModelOracle
        overrides this with ONE padded serving batch for all windows."""
        return [self.rank_batch(list(b), criteria) for b in batches]

    def compare_batch(self, pairs: Sequence[tuple[Key, Key]],
                      criteria: str) -> list[int]:
        """One round of independent pairwise comparisons: ``+1``/``-1`` per
        pair, aligned with ``pairs`` (same semantics as :meth:`compare`)."""
        return [self.compare(a, b, criteria) for a, b in pairs]

    def inquire_batch(self, keys: Sequence[Key], criteria: str) -> list[bool]:
        """One round of independent membership inquiries (Prompt Block 4)."""
        return [self.inquire(k, criteria) for k in keys]

    def score_each(self, keys: Sequence[Key], criteria: str) -> list[float]:
        """One round of independent POINTWISE scores: each key is a logical
        single-key ``score_batch`` call (pointwise noise regime, pointwise
        billing) — unlike ``score_batch(keys)``, which is one m-key call."""
        return [self.score_batch([k], criteria)[0] for k in keys]

    def score_batches(self, batches: Sequence[Sequence[Key]],
                      criteria: str) -> list[list[float]]:
        """One round of independent m-key scoring calls (external pointwise):
        each batch is billed/noised as its own ``score_batch`` call."""
        return [self.score_batch(list(b), criteria) for b in batches]

    # ---- failure-isolating round execution ------------------------------
    # A round's calls are independent by definition, so ONE structurally
    # invalid element must not poison its round-mates: the ``try_`` variants
    # return ``None`` in place of each failing element (the failed attempt
    # is still billed, as production billing would).  Defaults catch per
    # element around the point verbs; backends whose batched implementation
    # cannot fail per element (ModelOracle logit probes) delegate straight
    # to the batched verb.  ``Ordering`` uses these so its retry/split
    # fallback re-runs ONLY the failing elements, keeping ledger accounting
    # identical to sequential execution even under failures.

    def try_rank_batches(self, batches: Sequence[Sequence[Key]],
                         criteria: str) -> list:
        out = []
        for b in batches:
            try:
                out.append(self.rank_batch(list(b), criteria))
            except InvalidOutputError:
                out.append(None)
        return out

    def try_score_batches(self, batches: Sequence[Sequence[Key]],
                          criteria: str) -> list:
        out = []
        for b in batches:
            try:
                out.append(self.score_batch(list(b), criteria))
            except InvalidOutputError:
                out.append(None)
        return out

    def try_score_each(self, keys: Sequence[Key], criteria: str) -> list:
        out = []
        for k in keys:
            try:
                out.append(self.score_batch([k], criteria)[0])
            except InvalidOutputError:
                out.append(None)
        return out

    # ---- billing helpers -------------------------------------------------
    # ``tier=None`` bills at the oracle's ambient ``bill_tier``; cascade
    # oracles pass an explicit tier per wave.
    def _charge_score(self, keys: Sequence[Key], tag: str = "",
                      tier: Optional[str] = None) -> None:
        c = self.costs
        inp = c.score_prefix + sum(k.tokens() for k in keys)
        out = c.score_out_per_key * len(keys)
        self.ledger.charge("score", inp, out, n_keys=len(keys), tag=tag,
                           tier=self.bill_tier if tier is None else tier)

    def _charge_compare(self, a: Key, b: Key, tag: str = "",
                        tier: Optional[str] = None) -> None:
        c = self.costs
        self.ledger.charge("compare", c.compare_prefix + a.tokens() + b.tokens(),
                           c.compare_out, n_keys=2, tag=tag,
                           tier=self.bill_tier if tier is None else tier)

    def _charge_rank(self, keys: Sequence[Key], tag: str = "",
                     tier: Optional[str] = None) -> None:
        c = self.costs
        inp = c.rank_prefix + sum(k.tokens() for k in keys)
        out = c.rank_out_per_key * len(keys)
        self.ledger.charge("rank", inp, out, n_keys=len(keys), tag=tag,
                           tier=self.bill_tier if tier is None else tier)

    def _charge_inquire(self, key: Key, tag: str = "",
                        tier: Optional[str] = None) -> None:
        c = self.costs
        self.ledger.charge("inquire", c.inquire_prefix + key.tokens(),
                           c.inquire_out, tag=tag,
                           tier=self.bill_tier if tier is None else tier)

    def _charge_judge(self, keys: Sequence[Key], candidates: Sequence[Sequence[Key]],
                      tag: str = "") -> int:
        """Returns the judge input token count (used for context-degradation)."""
        c = self.costs
        inp = (c.judge_prefix + sum(k.tokens() for k in keys)
               + sum(3 * len(cand) for cand in candidates))  # id lists
        self.ledger.charge("judge", inp, c.judge_out, n_keys=len(keys), tag=tag,
                           tier=self.bill_tier)
        return inp

    # ---- reporting -------------------------------------------------------
    def spend(self) -> float:
        return self.ledger.cost(self.prices)
