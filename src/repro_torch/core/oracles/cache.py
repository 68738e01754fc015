"""Client-side LLM output cache (Sec. 3.1) and the cross-query semantic
memo.

"Repeated prompts with identical inputs are served directly from the cache,
reducing redundant LLM function calls" — this is what turns Alg. 1's batch-size
search into O(log2 m) *billed* calls.  The cache key is the full logical
prompt — (verb, uid tuple, criteria) — NORMALIZED: the criteria string is
whitespace-canonicalized and the whole key is hashed stably (blake2b), so
logically identical comparisons issued by different queries (or different
spellings of one criteria) actually share entries, and keys are identical
across processes (unlike ``hash()``), which is what a persisted or shared
cache needs.

:class:`SemanticMemo` extends the idea ACROSS queries: a shared store of
raw probe results — comparisons, pointwise scores, membership inquiries —
keyed on the same normalized (kind, uids, criteria) identity, consulted by
``ModelOracle.begin_probe_round`` before emitting probes (see
``llm_order_by_many(..., semantic_memo=...)``).  Raw compare probes are
direction-free (the A-vs-B logit readout; direction is folded client-side
by ``Ordering.fold_compares``), so ASC and DESC queries over one criteria
share entries by construction.  Billing is first-requester-pays: the miss
that populates an entry is billed normally and its :class:`CallRecord` is
stored beside the value; a later hit is free but logs a (ledger position,
record) shadow pair on its oracle, so ``reconciled_records()`` can rebuild
the exact solo ledger — sum of per-query billed ledgers + hit shadows ==
the records of every query run alone.  See DESIGN.md "Locality scheduling
& cross-query cache".

Counterpart of ``src/repro/core/oracles/cache.py`` (copied; only imports and
cross-references point at the port)."""
from __future__ import annotations

import hashlib
from typing import Sequence

from ..types import Key
from .base import CallRecord, Oracle


def canon_criteria(criteria: str) -> str:
    """Criteria normalization for cache/memo keys: strip the ends and
    collapse internal whitespace runs, so cosmetic spellings of one
    criteria ("relevance", " relevance\\n") share entries.  Key identity
    only — the prompt sent to the backend keeps the caller's exact
    string."""
    return " ".join(criteria.split())


def stable_key(*parts) -> str:
    """Order-sensitive stable hash of a cache key: blake2b over the repr
    of the parts.  Identical across processes and runs (``hash()`` is
    salted per process), compact, and collision-safe at 128 bits."""
    return hashlib.blake2b(repr(parts).encode(), digest_size=16).hexdigest()


class SemanticMemo:
    """Cross-query semantic probe cache (ModelOracle deferred rounds).

    Stores ``key -> (raw value, billed CallRecord)`` for the per-item
    probe kinds — ``compare`` / ``score_each`` / ``inquire`` — under
    first-requester-pays billing (module docstring).  Values are RAW probe
    results (direction-free compares, unfolded scores), so every query
    direction/limit folds them independently and per-query orderings stay
    byte-identical to solo execution.  Attach with
    ``llm_order_by_many(..., semantic_memo=SemanticMemo())`` or by setting
    ``oracle.memo`` directly; one instance may serve any number of
    sequential ``llm_order_by_many`` calls (that is the point)."""

    #: deferred round kind -> billing/record kind of one item
    KINDS = {"compare": "compare", "score_each": "score",
             "inquire": "inquire"}

    def __init__(self) -> None:
        self._store: dict[str, tuple] = {}
        self.hits = 0
        self.misses = 0

    def __len__(self) -> int:
        return len(self._store)

    def key(self, kind: str, item, criteria: str) -> str:
        """The normalized identity of one probe: (item kind, uid tuple,
        canonical criteria), stably hashed.  ``item`` matches the deferred
        round payload: a (Key, Key) pair for ``compare``, a Key
        otherwise."""
        uids = ((item[0].uid, item[1].uid) if kind == "compare"
                else (item.uid,))
        return stable_key(self.KINDS[kind], uids, canon_criteria(criteria))

    def get(self, key: str):
        """(value, record) or None."""
        return self._store.get(key)

    def put(self, key: str, value, record: CallRecord) -> None:
        # setdefault: when two oracles miss the same key in one tick (both
        # already billed — first-REQUESTERS-pay), the first finisher's
        # value wins and the store never flips under a reader
        self._store.setdefault(key, (value, record))


class CachingOracle(Oracle):
    """Transparent memoizing wrapper around any Oracle.

    Billing: cache hits are free (no ledger charge); misses delegate and are
    billed by the inner oracle.  Both ledgers stay visible — ``self.ledger``
    aliases the inner ledger so access paths keep exact accounting.
    """

    def __init__(self, inner: Oracle):
        # Note: deliberately NOT calling super().__init__ — we alias the inner
        # oracle's ledger/prices so all accounting lands in one place.
        self.inner = inner
        self.ledger = inner.ledger
        self.prices = inner.prices
        self.costs = inner.costs
        self._cache: dict = {}
        self.hits = 0
        self.misses = 0

    @staticmethod
    def _ck(kind: str, uids, criteria: str) -> str:
        """Normalized cache key: whitespace-canonical criteria + stable
        hashing (module docstring), so logically identical calls from
        different queries hit regardless of criteria spelling."""
        return stable_key(kind, tuple(uids), canon_criteria(criteria))

    def _memo(self, cache_key, thunk):
        if cache_key in self._cache:
            self.hits += 1
            return self._cache[cache_key]
        self.misses += 1
        val = thunk()
        self._cache[cache_key] = val
        return val

    def score_batch(self, keys: Sequence[Key], criteria: str) -> list[float]:
        ck = self._ck("score", (k.uid for k in keys), criteria)
        return list(self._memo(ck, lambda: self.inner.score_batch(keys, criteria)))

    def compare(self, a: Key, b: Key, criteria: str) -> int:
        ck = self._ck("compare", (a.uid, b.uid), criteria)
        return self._memo(ck, lambda: self.inner.compare(a, b, criteria))

    def rank_batch(self, keys: Sequence[Key], criteria: str) -> list[Key]:
        ck = self._ck("rank", (k.uid for k in keys), criteria)
        return list(self._memo(ck, lambda: self.inner.rank_batch(keys, criteria)))

    def inquire(self, key: Key, criteria: str) -> bool:
        ck = self._ck("inquire", (key.uid,), criteria)
        return self._memo(ck, lambda: self.inner.inquire(key, criteria))

    # ---- round (batch) verbs: per-element memoization ---------------------
    # Each element of a round shares its cache entry with the equivalent
    # point call; only the misses are forwarded, still as one round (one
    # serving submission on a ModelOracle inner).

    def _memo_round(self, cache_keys, items, forward):
        # forward must not return None elements (the batch verbs never do);
        # the try_ variant handles the general case
        return self._memo_try_round(cache_keys, items, forward)

    def compare_batch(self, pairs, criteria: str) -> list[int]:
        cks = [self._ck("compare", (a.uid, b.uid), criteria) for a, b in pairs]
        return self._memo_round(
            cks, list(pairs), lambda ps: self.inner.compare_batch(ps, criteria))

    def inquire_batch(self, keys: Sequence[Key], criteria: str) -> list[bool]:
        cks = [self._ck("inquire", (k.uid,), criteria) for k in keys]
        return self._memo_round(
            cks, list(keys), lambda ks: self.inner.inquire_batch(ks, criteria))

    def score_each(self, keys: Sequence[Key], criteria: str) -> list[float]:
        # same cache keys (and list-valued entries) as score_batch([k])
        cks = [self._ck("score", (k.uid,), criteria) for k in keys]
        out = self._memo_round(
            cks, list(keys),
            lambda ks: [[v] for v in self.inner.score_each(ks, criteria)])
        return [float(v[0]) for v in out]

    def score_batches(self, batches, criteria: str) -> list[list[float]]:
        cks = [self._ck("score", (k.uid for k in b), criteria) for b in batches]
        return [list(v) for v in self._memo_round(
            cks, [list(b) for b in batches],
            lambda bs: self.inner.score_batches(bs, criteria))]

    # failure-isolating rounds: misses forward as one round; a None result
    # (structural failure) is returned but never cached, so a later retry
    # reaches the backend again.
    def _memo_try_round(self, cache_keys, items, forward):
        # dedup within the round: a repeat of a key whose first occurrence
        # SUCCEEDS is a hit (a sequential loop would serve it from cache);
        # a repeat of a key whose first occurrence failed structurally must
        # re-reach — and re-bill — the backend, exactly like the sequential
        # loop's cache miss (None is never cached).  Unique misses forward
        # as one round; repeats of failed keys forward as a follow-up round.
        missing: list[int] = []
        dup_later: list[int] = []
        seen: set = set()
        for i, ck in enumerate(cache_keys):
            if ck in self._cache:
                self.hits += 1
            elif ck in seen:
                dup_later.append(i)                # outcome not known yet
            else:
                self.misses += 1
                seen.add(ck)
                missing.append(i)
        out: dict[int, object] = {}

        def run(idx):
            for i, val in zip(idx, forward([items[i] for i in idx])):
                out[i] = val
                if val is not None:
                    self._cache[cache_keys[i]] = val

        if missing:
            run(missing)
        retry = [i for i in dup_later if cache_keys[i] not in self._cache]
        self.hits += len(dup_later) - len(retry)
        if retry:
            self.misses += len(retry)
            run(retry)
        # per-occurrence results: an occurrence that reached the backend
        # keeps its own value (even if a later retry of the same key
        # succeeded); the rest read the cache.
        return [out[i] if i in out else self._cache.get(ck)
                for i, ck in enumerate(cache_keys)]

    def try_rank_batches(self, batches, criteria: str) -> list:
        cks = [self._ck("rank", (k.uid for k in b), criteria) for b in batches]
        return self._memo_try_round(
            cks, [list(b) for b in batches],
            lambda bs: self.inner.try_rank_batches(bs, criteria))

    def try_score_batches(self, batches, criteria: str) -> list:
        cks = [self._ck("score", (k.uid for k in b), criteria) for b in batches]
        return self._memo_try_round(
            cks, [list(b) for b in batches],
            lambda bs: self.inner.try_score_batches(bs, criteria))

    def try_score_each(self, keys: Sequence[Key], criteria: str) -> list:
        cks = [self._ck("score", (k.uid,), criteria) for k in keys]
        out = self._memo_try_round(
            cks, list(keys),
            lambda ks: [None if v is None else [v]
                        for v in self.inner.try_score_each(ks, criteria)])
        return [None if v is None else float(v[0]) for v in out]

    def judge(self, keys, criteria, candidates):
        ck = self._ck("judge", (tuple(k.uid for k in keys),
                        tuple(tuple(k.uid for k in c) for c in candidates)),
                   criteria)
        return self._memo(ck, lambda: self.inner.judge(keys, criteria, candidates))
