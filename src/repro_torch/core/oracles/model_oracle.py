"""ModelOracle: the Oracle interface backed by REAL PyTorch forward passes
through the serving engine — the production path of the LLM ORDER BY
operator.  Token billing uses actual tokenizer counts (not estimates), so the
optimizer's cost model calibrates against genuine serving costs.

Every access path and both optimizer strategies run unchanged against this
backend (tests/test_model_oracle.py), which is the point of the paper's
"semantic black box" framing: the physical sorting algorithms are oblivious
to whether the comparator is an API or a pod-hosted model.

Counterpart of ``src/repro/core/oracles/model_oracle.py`` (copied; only imports and
cross-references point at the port)."""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

from ..types import Key
from .base import LLAMA70B, Oracle, PriceSheet, PromptCosts, PromptParts


class ModelOracle(Oracle):
    def __init__(self, engine, prices: PriceSheet = LLAMA70B,
                 costs: Optional[PromptCosts] = None,
                 judge_rationale_tokens: int = 0,
                 scheduler=None):
        super().__init__(prices=prices, costs=costs)
        self.engine = engine
        # > 0: the judge free-decodes a rationale per candidate before the
        # quality probe (Sec. 5.4's CoT judging) — a mixed-length generation
        # workload served by the engine's continuous-batching loop; the
        # candidates share one prefix-KV block run (criteria + sample)
        self.judge_rationale_tokens = judge_rationale_tokens
        # optional BatchScheduler: when attached (llm_order_by_many and the
        # optimizer attach their shared scheduler automatically), rationale
        # generations run THROUGH the unified step loop — probe rounds from
        # concurrent plans are answered in this oracle's decode step gaps
        # instead of waiting for the whole generation to drain
        self.scheduler = scheduler
        # optional cross-query SemanticMemo (core/oracles/cache.py),
        # consulted by begin_probe_round for the per-item kinds: memo hits
        # skip both billing AND the backend probe (first-requester-pays),
        # and are logged as (ledger position, stored CallRecord) shadow
        # pairs so reconciled_records() rebuilds the exact solo ledger.
        # None (the default) keeps deferred rounds byte-identical to the
        # synchronous verbs — attach via llm_order_by_many(semantic_memo=)
        self.memo = None
        self.memo_hit_log: list[tuple[int, object]] = []
        # serving tenant class this oracle's probe rounds and rationale
        # generations ride under (scheduler.TenantSpec); "default" keeps
        # every sink call signature-compatible with non-tenant schedulers.
        # llm_order_by_many scopes this per query (operator.attach_tenants)
        self.tenant = "default"

    # -- billing helpers using real token counts -----------------------------
    def _real_tokens(self, text: str) -> int:
        return len(self.engine.tok.encode(text))

    def score_batch(self, keys: Sequence[Key], criteria: str) -> list[float]:
        inp = self.costs.score_prefix + sum(self._real_tokens(k.text) for k in keys)
        self.ledger.charge("score", inp, self.costs.score_out_per_key * len(keys),
                           n_keys=len(keys), tier=self.bill_tier)
        return self.engine.score([k.text for k in keys], criteria)

    def compare(self, a: Key, b: Key, criteria: str) -> int:
        inp = (self.costs.compare_prefix + self._real_tokens(a.text)
               + self._real_tokens(b.text))
        self.ledger.charge("compare", inp, self.costs.compare_out, n_keys=2,
                           tier=self.bill_tier)
        return self.engine.compare(a.text, b.text, criteria)

    def compare_batch(self, pairs, criteria: str) -> list[int]:
        """One round of independent comparisons in ONE padded serving
        submission; billed as len(pairs) logical compare calls (same records
        as the sequential default, same convention as rank_batches)."""
        if not pairs:
            return []
        for a, b in pairs:
            inp = (self.costs.compare_prefix + self._real_tokens(a.text)
                   + self._real_tokens(b.text))
            self.ledger.charge("compare", inp, self.costs.compare_out, n_keys=2,
                               tier=self.bill_tier)
        return self.engine.compare_many(
            [(a.text, b.text) for a, b in pairs], criteria)

    def rank_batch(self, keys: Sequence[Key], criteria: str) -> list[Key]:
        inp = self.costs.rank_prefix + sum(self._real_tokens(k.text) for k in keys)
        self.ledger.charge("rank", inp, self.costs.rank_out_per_key * len(keys),
                           n_keys=len(keys), tier=self.bill_tier)
        perm = self.engine.rank_window([k.text for k in keys], criteria)
        return [keys[i] for i in perm]

    @staticmethod
    def _split_rounds(scores, batches, rank: bool):
        """Split a flat per-key score list back into per-batch results:
        stable-argsorted key permutations (``rank``) or raw score lists.
        Shared by the synchronous round verbs AND finish_probe_round, so
        deferred and solo interpretation cannot drift apart."""
        out, i = [], 0
        for b in batches:
            s = scores[i:i + len(b)]
            i += len(b)
            if rank:
                order = np.argsort(np.asarray(s), kind="stable")
                out.append([b[j] for j in order])
            else:
                out.append(list(s))
        return out

    def rank_batches(self, batches, criteria: str):
        """Parallel run generation: score every window's keys in ONE padded
        serving batch (shared criteria prefix), then split and argsort."""
        flat = [k.text for b in batches for k in b]
        if not flat:
            return []
        # billed as len(batches) logical calls, executed as one submission
        for b in batches:
            self.ledger.charge(
                "rank",
                self.costs.rank_prefix + sum(self._real_tokens(k.text) for k in b),
                self.costs.rank_out_per_key * len(b), n_keys=len(b),
                tier=self.bill_tier)
        return self._split_rounds(self.engine.score(flat, criteria),
                                  batches, rank=True)

    def score_each(self, keys: Sequence[Key], criteria: str) -> list[float]:
        """N logical single-key score calls, ONE serving submission."""
        if not keys:
            return []
        for k in keys:
            self.ledger.charge("score",
                               self.costs.score_prefix + self._real_tokens(k.text),
                               self.costs.score_out_per_key, n_keys=1,
                               tier=self.bill_tier)
        return self.engine.score([k.text for k in keys], criteria)

    def score_batches(self, batches, criteria: str) -> list[list[float]]:
        """N logical m-key score calls, ONE serving submission."""
        flat = [k.text for b in batches for k in b]
        if not flat:
            return [[] for _ in batches]
        for b in batches:
            inp = self.costs.score_prefix + sum(self._real_tokens(k.text) for k in b)
            self.ledger.charge("score", inp, self.costs.score_out_per_key * len(b),
                               n_keys=len(b), tier=self.bill_tier)
        return self._split_rounds(self.engine.score(flat, criteria),
                                  batches, rank=False)

    # logit probes cannot fail structurally: the failure-isolating round
    # variants are exactly the batched submissions
    def try_rank_batches(self, batches, criteria: str) -> list:
        return self.rank_batches(batches, criteria)

    def try_score_batches(self, batches, criteria: str) -> list:
        return self.score_batches(batches, criteria)

    def try_score_each(self, keys: Sequence[Key], criteria: str) -> list:
        return self.score_each(keys, criteria)

    # ---- deferred round verbs (probe-plan executor) -----------------------
    # A round can be split into BEGIN (bill the ledger — identical records
    # to the synchronous verb — and enqueue the round's prompts into a
    # BatchScheduler as ONE probe-round work item behind a RoundFuture) and
    # FINISH (read the future's logits and interpret them).  The executor
    # begins every suspended plan's round and pumps the unified step loop
    # once — all plans' probes of the tick ride that step's gap in shared
    # length-bucketed submissions with cross-plan dedup, while any in-flight
    # decode rows advance alongside; a round begun mid-generation therefore
    # resolves between decode steps instead of after the drain.  Deferral is
    # sound here because logit probes cannot fail structurally, so the
    # Ordering-level retry/split fallback has nothing to catch; the raw
    # results only need the direction fold applied
    # (``Ordering.fold_compares`` / ``fold_scores`` / ``fold_window_result``).

    def _probe_prompt(self, kind: str, item, criteria: str):
        """The serving prompt of ONE per-item probe (``compare`` /
        ``score_each`` / ``inquire``) — shared by begin_probe_round and
        :meth:`preview_round_prompts` so prefetch warms exactly the
        regions the round will touch."""
        if kind == "compare":
            a, b = item
            return self.engine._compare_parts(a.text, b.text, criteria)
        if kind == "score_each":
            return self.engine.score_parts(item.text, criteria)
        return self._inquire_prompt(item, criteria)

    def _charge_probe(self, kind: str, item, tier: Optional[str] = None) -> None:
        """Bill ONE per-item probe — identical record to the synchronous
        batch verbs.  ``tier=None`` bills at the ambient ``bill_tier``;
        the cascade oracle passes explicit "draft"/"large" per wave."""
        tier = self.bill_tier if tier is None else tier
        if kind == "compare":
            a, b = item
            inp = (self.costs.compare_prefix + self._real_tokens(a.text)
                   + self._real_tokens(b.text))
            self.ledger.charge("compare", inp, self.costs.compare_out,
                               n_keys=2, tier=tier)
        elif kind == "score_each":
            self.ledger.charge(
                "score",
                self.costs.score_prefix + self._real_tokens(item.text),
                self.costs.score_out_per_key, n_keys=1, tier=tier)
        else:
            self.ledger.charge(
                "inquire",
                self.costs.inquire_prefix + self._real_tokens(item.text),
                self.costs.inquire_out, tier=tier)

    def preview_round_prompts(self, kind: str, payload, criteria: str) -> list:
        """The prompts the NEXT ``begin_probe_round(kind, payload, ...)``
        call will submit, built WITHOUT billing or side effects — the
        executor's prefetch pipeline warms their prefix regions in an
        earlier step gap.  Memo-resident items are excluded: they will
        never reach the backend, so warming their regions is waste."""
        if kind in ("score_batches", "rank_windows"):
            return [self.engine.score_parts(k.text, criteria)
                    for b in payload for k in b]
        if kind not in ("compare", "score_each", "inquire"):
            return []
        items = payload
        if self.memo is not None:
            items = [it for it in payload
                     if self.memo.get(self.memo.key(kind, it, criteria))
                     is None]
        return [self._probe_prompt(kind, it, criteria) for it in items]

    def begin_probe_round(self, kind: str, payload, criteria: str, sink):
        """Bill one round now and enqueue its prompts into ``sink`` (a
        BatchScheduler); returns an opaque token for
        :meth:`finish_probe_round`.  ``kind`` is one of ``compare`` /
        ``score_each`` / ``score_batches`` / ``rank_windows`` /
        ``inquire``; ``payload`` matches the corresponding batch verb.

        With a :class:`~repro_torch.core.oracles.cache.SemanticMemo` attached
        (``self.memo``), the per-item kinds consult it first: a hit skips
        billing and the probe (logging a reconciliation shadow — see
        :meth:`reconciled_records`); misses are billed normally and their
        values land in the memo at finish time, CallRecord attached."""
        eng = self.engine
        prompts: list = []
        meta = None
        plan = None                    # memo plan: (hits, keys, records)
        if kind in ("compare", "score_each", "inquire"):
            hits: dict[int, object] = {}
            miss_keys: list = []
            miss_records: list = []
            for i, item in enumerate(payload):
                mkey = None
                if self.memo is not None:
                    mkey = self.memo.key(kind, item, criteria)
                    ent = self.memo.get(mkey)
                    if ent is not None:
                        value, record = ent
                        hits[i] = value
                        self.memo.hits += 1
                        self.memo_hit_log.append(
                            (len(self.ledger.records), record))
                        continue
                    self.memo.misses += 1
                self._charge_probe(kind, item)
                miss_keys.append(mkey)
                miss_records.append(self.ledger.records[-1])
                prompts.append(self._probe_prompt(kind, item, criteria))
            if self.memo is not None:
                plan = (hits, miss_keys, miss_records)
        elif kind in ("score_batches", "rank_windows"):
            bill_kind = "score" if kind == "score_batches" else "rank"
            prefix = (self.costs.score_prefix if kind == "score_batches"
                      else self.costs.rank_prefix)
            per_key = (self.costs.score_out_per_key if kind == "score_batches"
                       else self.costs.rank_out_per_key)
            for b in payload:
                inp = prefix + sum(self._real_tokens(k.text) for k in b)
                self.ledger.charge(bill_kind, inp, per_key * len(b),
                                   n_keys=len(b), tier=self.bill_tier)
                prompts.extend(eng.score_parts(k.text, criteria) for k in b)
            meta = [list(b) for b in payload]
        else:
            raise ValueError(f"unknown deferred round kind {kind!r}")
        if hasattr(sink, "submit_probe_round"):
            if self.tenant != "default":   # default stays signature-neutral
                return (kind, sink.submit_probe_round(
                    prompts, tenant=self.tenant), meta, plan)
            return (kind, sink.submit_probe_round(prompts), meta, plan)
        # legacy sink: per-probe rids read back from sink.probe_results
        return (kind, [sink.submit_probe(p) for p in prompts], meta, plan)

    def finish_probe_round(self, token, sink):
        """Interpret one begun round's logits.  Future-based rounds resolve
        through the sink's step loop (``sink.resolve`` pumps until the
        round's step gap has serviced it — at most one step away); legacy
        rid rounds read ``sink.probe_results``.  Returns the same raw
        values the synchronous batch verb would have.  Rounds begun with a
        memo plan fan hits and fresh results back into payload order and
        publish the fresh values (with their billed CallRecords) to the
        memo."""
        from ...serving.engine import read_compare, read_score, read_yes_no
        kind, handle, meta, plan = token
        if hasattr(handle, "result"):            # RoundFuture
            if not handle.done:
                sink.resolve(handle)
            logits = handle.result()
        else:
            logits = [sink.probe_results.pop(rid) for rid in handle]
        if kind in ("score_batches", "rank_windows"):
            return self._split_rounds([read_score(l) for l in logits], meta,
                                      rank=(kind == "rank_windows"))
        read = {"compare": read_compare, "score_each": read_score,
                "inquire": read_yes_no}[kind]
        fresh = [read(l) for l in logits]
        if plan is None:
            return fresh
        hits, miss_keys, miss_records = plan
        for mkey, value, record in zip(miss_keys, fresh, miss_records):
            self.memo.put(mkey, value, record)
        out: list = [None] * (len(hits) + len(fresh))
        it = iter(fresh)
        for i in range(len(out)):
            out[i] = hits[i] if i in hits else next(it)
        return out

    def reconciled_records(self) -> list:
        """This oracle's ledger with the memo hits' shadow
        :class:`CallRecord`\\ s re-inserted at the positions solo execution
        would have billed them — byte-identical (``==``) to the solo run's
        ``ledger.records`` when the memo'd values came from identical
        probes (the first-requester-pays reconciliation contract: sum of
        per-query billed ledgers + hit shadows == solo ledgers)."""
        out: list = []
        li = 0
        log = self.memo_hit_log
        for pos in range(len(self.ledger.records) + 1):
            while li < len(log) and log[li][0] == pos:
                out.append(log[li][1])
                li += 1
            if pos < len(self.ledger.records):
                out.append(self.ledger.records[pos])
        return out

    def _inquire_prompt(self, key: Key, criteria: str) -> PromptParts:
        # structured (shared_prefix, per_key_suffix): a whole membership
        # round shares one prefix-KV entry in the serving engine
        return PromptParts(
            f"You have seen the following {criteria}: \"",
            f"{key.text}\" in your training data? Answer Y or N:")

    def inquire(self, key: Key, criteria: str) -> bool:
        self.ledger.charge("inquire",
                           self.costs.inquire_prefix + self._real_tokens(key.text),
                           self.costs.inquire_out, tier=self.bill_tier)
        return self.engine.yes_no(self._inquire_prompt(key, criteria))

    def inquire_batch(self, keys: Sequence[Key], criteria: str) -> list[bool]:
        """One round of membership inquiries in ONE serving submission."""
        if not keys:
            return []
        for k in keys:
            self.ledger.charge("inquire",
                               self.costs.inquire_prefix + self._real_tokens(k.text),
                               self.costs.inquire_out, tier=self.bill_tier)
        return self.engine.yes_no_many(
            [self._inquire_prompt(k, criteria) for k in keys])

    def judge(self, keys: Sequence[Key], criteria: str,
              candidates: Sequence[Sequence[Key]]) -> int:
        self._charge_judge(keys, candidates)
        listings = [" > ".join(k.text[:40] for k in cand[:10])
                    for cand in candidates]
        prefix = f"Criteria: {criteria}\nRanking:"
        rationales = [""] * len(candidates)
        if self.judge_rationale_tokens > 0 and candidates:
            # free-decode a rationale per candidate ranking: candidate
            # rationales are independent mixed-length generations, so they
            # ride the continuous-batching loop (short verdicts retire
            # early; the shared criteria prefix is one pinned block run).
            # With a scheduler attached they run THROUGH the unified step
            # loop, so concurrent plans' probe rounds are answered in this
            # generation's step gaps instead of behind the whole drain.
            rationale_prompts = [
                PromptParts(prefix, f" {lst}\nJudge rationale:")
                for lst in listings]
            if self.scheduler is not None and self.scheduler.paged \
                    and self.scheduler.engine is self.engine:
                kw = ({} if self.tenant == "default"
                      else {"tenant": self.tenant})
                rationales = self.scheduler.generate(
                    rationale_prompts, max_new=self.judge_rationale_tokens,
                    **kw)
            else:
                rationales = self.engine.generate(
                    rationale_prompts, max_new=self.judge_rationale_tokens)
            for r in rationales:
                self.ledger.charge("judge", 0,
                                   self._real_tokens(r) if r else 1,
                                   n_keys=0, tag="rationale",
                                   tier=self.bill_tier)
        # score each candidate ranking as a whole via a quality probe prompt
        prompts = []
        for lst, rat in zip(listings, rationales):
            suffix = (f" {lst}\nQuality rating:" if not rat else
                      f" {lst}\nRationale: {rat}\nQuality rating:")
            prompts.append(PromptParts(prefix, suffix))
        logits = self.engine.last_logits(prompts)
        from ...serving.engine import read_score
        scores = [read_score(l) for l in logits]
        return int(np.argmax(scores))
