"""Probe-plan executor: resumable access paths over a shared probe stream.

An access path no longer *calls* the oracle mid-algorithm; it *describes*
its next round of independent probes by yielding a typed probe set and
suspends until the results arrive at the yield point:

 * :class:`ComparePairs`  — pairwise comparisons; results are
   ``[a precedes b in the output]`` booleans (direction already folded),
 * :class:`ScoreEach`     — single-key pointwise scores (ascending sort of
   the returned values gives output order),
 * :class:`ScoreBatches`  — independent m-key scoring calls,
 * :class:`RankWindows`   — independent listwise windows, returned in
   output order,
 * :class:`InquireEach`   — membership inquiries (Prompt Block 4),
 * :class:`SerialProbe`   — escape hatch for inherently sequential,
   data-dependent subroutines (Alg. 1 adaptive batch sizing): resolved by
   calling ``fn(ordering)`` immediately and never merged across plans.

Solo execution (:meth:`AccessPath.execute`) drives a single plan through
:func:`drive_plan`, resolving each probe set with the matching
:class:`~repro_torch.core.access_paths.base.Ordering` round verb — so the
retry/binary-split fallback, the billing convention, and the output are
exactly the PR-1 synchronous semantics (``Ordering``'s round verbs are the
thin synchronous adapter over single-plan execution).

Concurrent execution (:class:`ProbePlanExecutor`) drives any number of
plans in **ticks**: every tick, each suspended plan's ready probe set is
resolved once (fairness: no plan waits more than one tick behind its
round-mates), and on a deferred-capable backend (ModelOracle + a
``BatchScheduler``) all plans' rounds are begun as future-backed probe
work and the tick pumps ONE step of the unified serving loop — the rounds
ride that step's gap merged into shared length-bucketed submissions with
cross-plan dedup of identical prompts, while any in-flight decode rows
(judge rationales, another driver's generates) advance one token in the
same step instead of the tick waiting behind their drain.  Per-plan ledger
records are tracked even on a shared oracle, so a plan's accounting under
the executor is record-for-record identical to its solo run.  See
DESIGN.md "Probe-plan executor" and "Unified step loop".

Counterpart of ``src/repro/core/executor.py`` (copied; only imports and
cross-references point at the port)."""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional, Sequence

from .oracles.base import CallRecord, LedgerView
from .types import InvalidOutputError, SortResult, SortSpec


# --------------------------------------------------------------- probe sets
@dataclass
class ComparePairs:
    """Result: ``[a precedes b in the output]`` per pair."""
    pairs: list  # [(Key, Key)]


@dataclass
class ScoreEach:
    """Result: one direction-folded score per key (pointwise billing)."""
    keys: list


@dataclass
class ScoreBatches:
    """Result: one direction-folded score list per chunk (one m-key call
    each — the external-pointwise billing regime)."""
    chunks: list  # [[Key]]


@dataclass
class RankWindows:
    """Result: each window's keys permuted into output order."""
    batches: list  # [[Key]]


@dataclass
class InquireEach:
    """Result: one membership boolean per key (no direction to fold)."""
    keys: list


@dataclass
class SerialProbe:
    """Sequential, data-dependent subroutine: resolved as ``fn(ordering)``
    the moment its plan is serviced; opaque to cross-plan merging."""
    fn: Callable


class PlanCancelled(RuntimeError):
    """A plan was cancelled by its driver (budget cut, short-circuit)."""


# ---------------------------------------------------------- sync resolution
def resolve_probes(ordering, ps, coalesce: bool = True):
    """Resolve one probe set against an :class:`Ordering` synchronously.

    ``coalesce=True`` uses the round verbs (one backend submission where the
    oracle supports it, retry/split fallback per sub-batch); ``coalesce=False``
    replays the seed's sequential point-call structure — same results under
    any deterministic-per-prompt oracle, same ledger multiset."""
    if isinstance(ps, ComparePairs):
        if coalesce:
            return ordering.before_many(ps.pairs)
        return [ordering.before(a, b) for a, b in ps.pairs]
    if isinstance(ps, ScoreEach):
        if coalesce:
            return ordering.scores_each(ps.keys)
        out = []
        for k in ps.keys:
            out.extend(ordering.scores([k]))
        return out
    if isinstance(ps, ScoreBatches):
        if coalesce:
            return ordering.scores_many(ps.chunks)
        return [ordering.scores(list(c)) for c in ps.chunks]
    if isinstance(ps, RankWindows):
        if coalesce:
            return ordering.windows(ps.batches)
        return [ordering.window(list(b)) for b in ps.batches]
    if isinstance(ps, InquireEach):
        crit = ordering.spec.criteria
        if coalesce:
            return ordering.oracle.inquire_batch(list(ps.keys), crit)
        return [ordering.oracle.inquire(k, crit) for k in ps.keys]
    if isinstance(ps, SerialProbe):
        return ps.fn(ordering)
    raise TypeError(f"unknown probe set {type(ps).__name__}")


def drive_plan(gen, ordering, coalesce: bool = True):
    """Drive one plan to completion synchronously (the solo adapter used by
    :meth:`AccessPath.execute`); returns the plan's return value."""
    try:
        ps = next(gen)
        while True:
            ps = gen.send(resolve_probes(ordering, ps, coalesce))
    except StopIteration as stop:
        return stop.value


# ----------------------------------------------------- deferred round glue
_DEFERRED_KIND = {
    ComparePairs: "compare",
    ScoreEach: "score_each",
    ScoreBatches: "score_batches",
    RankWindows: "rank_windows",
    InquireEach: "inquire",
}


def _deferred_payload(ps):
    if isinstance(ps, ComparePairs):
        return list(ps.pairs)
    if isinstance(ps, (ScoreEach, InquireEach)):
        return list(ps.keys)
    if isinstance(ps, ScoreBatches):
        return [list(c) for c in ps.chunks]
    if isinstance(ps, RankWindows):
        return [list(b) for b in ps.batches]
    return None


def _fold_raw(ordering, ps, raw):
    """Apply the Ordering direction fold to a deferred round's raw results —
    the same post-processing the synchronous round verbs perform."""
    if isinstance(ps, ComparePairs):
        return ordering.fold_compares(raw)
    if isinstance(ps, ScoreEach):
        return ordering.fold_scores(raw)
    if isinstance(ps, ScoreBatches):
        return [ordering.fold_scores(v) for v in raw]
    if isinstance(ps, RankWindows):
        return [ordering.fold_window_result(r) for r in raw]
    return raw


# ------------------------------------------------------------------- plans
class PlanRun:
    """One plan's execution state under the executor."""

    def __init__(self, name: str, gen, ordering, coalesce: bool = True,
                 path=None, tenant: str = "default"):
        self.name = name
        self.gen = gen
        self.ordering = ordering
        self.coalesce = coalesce
        self.path = path               # AccessPath instance (describe_params)
        self.tenant = tenant           # serving tenant class (TenantSpec)
        self.pending = None            # probe set awaiting resolution
        self.primed = False
        self.done = False
        self.result = None
        self.error: Optional[BaseException] = None
        self.records: list[CallRecord] = []   # this plan's ledger slice
        self.ticks = 0

    def cancel(self, reason: str = "cancelled") -> None:
        if self.done:
            return
        self.gen.close()
        self.done = True
        self.error = PlanCancelled(reason)

    # internal: advance the generator one step
    def _advance(self, value) -> None:
        try:
            self.pending = self.gen.send(value) if self.primed else next(self.gen)
            self.primed = True
        except StopIteration as stop:
            self.done = True
            self.result = stop.value
        except InvalidOutputError as e:
            # unrecoverable structural failure escaping the retry/split
            # fallback — exactly what a solo run would raise
            self.done = True
            self.error = e

    def _fail(self, e: BaseException) -> None:
        self.gen.close()
        self.done = True
        self.error = e


class ProbePlanExecutor:
    """Dataflow executor over any number of probe plans.

    Tick semantics: every tick, each live plan's pending probe set is
    resolved exactly once and the plan resumes with the results.  With a
    ``scheduler`` (a :class:`~repro_torch.serving.scheduler.BatchScheduler`) and
    deferred-capable oracles (``begin_probe_round``/``finish_probe_round``
    — ModelOracle's logit probes, which cannot fail structurally), all
    plans' rounds of a tick are enqueued as future-backed probe work and
    ONE ``pump`` of the unified step loop services them: merged
    length-bucketed submissions, identical prompts deduplicated across
    plans, and any in-flight decode rows advancing alongside.  Oracles
    without deferred support (Simulated/Exact/Caching wrappers) resolve
    synchronously inside the tick — same interleaving, no serving-level
    merge.

    Billing: each plan's ledger records are captured per resolution, so
    ``run.records`` is record-for-record what a solo run of the same plan
    would have billed, even when plans share one oracle instance.

    Prefetch pipelining (``prefetch``, default on whenever a scheduler is
    attached): at the end of every tick — after plans advance and expose
    their NEXT pending probe sets — each deferrable plan's upcoming round
    is previewed (``ModelOracle.preview_round_prompts``, no billing) and
    the shared prefix regions worth warming
    (:func:`repro_torch.serving.locality.prefetch_candidates`) are enqueued as
    ``PrefixFill`` work on the scheduler.  The fills ride the NEXT step
    gap of the unified loop — overlapping any in-flight decode — so when
    the round's probes arrive a tick later, their regions are already
    LRU-resident.  Pure serving-side warm-up: routing, results, and
    ledgers are untouched (only candidate regions the routing policy
    would cache anyway are filled).
    """

    def __init__(self, scheduler=None, prefetch: Optional[bool] = None,
                 tenant_budgets: Optional[dict] = None):
        self.scheduler = scheduler
        self.prefetch = (scheduler is not None if prefetch is None
                         else prefetch and scheduler is not None)
        self.prefetches = 0            # PrefixFill work items enqueued
        self.runs: list[PlanRun] = []
        self.ticks = 0
        # per-tenant LEDGER budgets (billed input+output tokens): a tenant
        # whose plans' combined ledger slices cross its budget has every
        # remaining plan cancelled before the next round begins.  Merged
        # with the scheduler's TenantSpec.ledger_budget entries; an
        # explicit mapping here wins per name.
        self.tenant_budgets = dict(tenant_budgets or {})
        self.budget_cancelled = 0      # plans cancelled by a ledger budget

    # ------------------------------------------------------------- submit
    def submit_plan(self, gen, ordering, name: str = "",
                    coalesce: bool = True, path=None,
                    tenant: str = "default") -> PlanRun:
        run = PlanRun(name or f"plan-{len(self.runs)}", gen, ordering,
                      coalesce=coalesce, path=path, tenant=tenant)
        self.runs.append(run)
        return run

    def submit_path(self, path, keys, oracle, spec: SortSpec,
                    name: str = "", tenant: str = "default") -> PlanRun:
        """Convenience: submit one access path's plan on ``keys``."""
        from .access_paths.base import Ordering
        ordering = Ordering(oracle, spec)
        return self.submit_plan(path._plan(list(keys), spec), ordering,
                                name=name or path.name,
                                coalesce=path.params.coalesce, path=path,
                                tenant=tenant)

    # ---------------------------------------------------- ledger budgets
    def _ledger_budget(self, tenant: str) -> Optional[int]:
        if tenant in self.tenant_budgets:
            return self.tenant_budgets[tenant]
        specs = getattr(self.scheduler, "tenants", None)
        if specs and tenant in specs:
            return specs[tenant].ledger_budget
        return None

    def _tenant_billed(self, tenant: str) -> int:
        """Billed tokens (input + output) across this executor's runs of
        one tenant — the per-plan ledger slices, so a shared oracle bills
        each tenant only for its own plans' records."""
        return sum(r.input_tokens + r.output_tokens
                   for run in self.runs if run.tenant == tenant
                   for r in run.records)

    def _enforce_ledger_budgets(self, live: list) -> list:
        out = []
        for run in live:
            budget = self._ledger_budget(run.tenant)
            if budget is not None and self._tenant_billed(run.tenant) >= budget:
                run.cancel(f"tenant {run.tenant!r} ledger budget "
                           f"({budget} tokens) exhausted")
                self.budget_cancelled += 1
                continue
            out.append(run)
        return out

    # --------------------------------------------------------------- ticks
    def _can_defer(self, run: PlanRun, ps) -> bool:
        return (self.scheduler is not None and run.coalesce
                and type(ps) in _DEFERRED_KIND
                and hasattr(run.ordering.oracle, "begin_probe_round"))

    def tick(self) -> bool:
        """One scheduling tick; returns True while any plan remains live."""
        live = []
        for run in self.runs:
            if run.done:
                continue
            if not run.primed:
                run._advance(None)
            if not run.done:
                live.append(run)
        live = self._enforce_ledger_budgets(live)
        if not live:
            return False
        self.ticks += 1
        deferred: list[tuple[PlanRun, object, object]] = []
        ready: list[tuple[PlanRun, object]] = []
        for run in live:
            run.ticks += 1
            ps = run.pending
            ledger = run.ordering.oracle.ledger
            snap = ledger.snapshot()
            if self._can_defer(run, ps):
                payload = _deferred_payload(ps)
                token = run.ordering.oracle.begin_probe_round(
                    _DEFERRED_KIND[type(ps)], payload,
                    run.ordering.spec.criteria, self.scheduler)
                run.records.extend(ledger.records[snap:])
                deferred.append((run, ps, token))
                continue
            try:
                value = resolve_probes(run.ordering, ps, run.coalesce)
            except InvalidOutputError as e:
                run.records.extend(ledger.records[snap:])
                run._fail(e)
                continue
            run.records.extend(ledger.records[snap:])
            ready.append((run, value))
        if deferred:
            # ONE pump of the live loop for the whole tick: every deferred
            # plan's probes ride the next step gap in shared length-bucketed
            # submissions (identical prompts deduped across plans), and any
            # in-flight decode rows — a judge rationale generation, another
            # driver's rows — advance one token in the same step instead of
            # the tick waiting behind their drain.  begin_probe_round has
            # already billed and enqueued every round, so each token MUST be
            # finished even when the pump or an earlier fold raises: the
            # finally drain collects abandoned rounds so no billed probes
            # stay queued in the scheduler behind a propagating error
            pending = list(deferred)
            try:
                self.scheduler.pump()
                while pending:
                    run, ps, token = pending.pop(0)
                    raw = run.ordering.oracle.finish_probe_round(
                        token, self.scheduler)
                    # cascade rounds bill their escalation wave mid-pump;
                    # the token carries those records for exact per-plan
                    # attribution (drafts landed at begin time above)
                    run.records.extend(getattr(token, "extra_records", ()))
                    ready.append((run, _fold_raw(run.ordering, ps, raw)))
            finally:
                for run, _ps, token in pending:
                    try:
                        run.ordering.oracle.finish_probe_round(
                            token, self.scheduler)
                    except Exception:
                        pass  # best-effort drain on the error path
                    run.records.extend(getattr(token, "extra_records", ()))
        for run, value in ready:
            run._advance(value)
        if self.prefetch:
            self._prefetch_next_rounds()
        return any(not r.done for r in self.runs)

    def _prefetch_next_rounds(self) -> None:
        """Peek every live plan's NEXT pending probe set and enqueue
        prefix fills for the regions it will share, so the warm-ups ride
        the step gap(s) between this tick and the round's own service
        step (class docstring)."""
        prompts: list = []
        for run in self.runs:
            ps = run.pending
            if run.done or ps is None or not self._can_defer(run, ps):
                continue
            oracle = run.ordering.oracle
            if not hasattr(oracle, "preview_round_prompts"):
                continue
            prompts.extend(oracle.preview_round_prompts(
                _DEFERRED_KIND[type(ps)], _deferred_payload(ps),
                run.ordering.spec.criteria))
        if not prompts:
            return
        from ..serving.locality import prefetch_candidates
        fills = prefetch_candidates(self.scheduler.engine, prompts)
        if fills:
            self.scheduler.submit_prefix_fill(fills)
            self.prefetches += 1

    def run(self, on_tick: Optional[Callable] = None) -> list[PlanRun]:
        """Tick until every plan completes.  ``on_tick(self)`` runs after
        each tick and may submit new plans or cancel running ones."""
        while True:
            progressed = self.tick()
            if on_tick is not None:
                on_tick(self)
            if not progressed and all(r.done for r in self.runs):
                break
        return self.runs


def attach_scheduler(oracles: Sequence, scheduler) -> list:
    """Point each oracle that rides ``scheduler``'s engine (and has no
    scheduler of its own) at the shared live loop, so oracle-side
    generations (judge rationales) decode through it.  Returns the list of
    oracles actually attached — pass it to :func:`detach_scheduler` when
    the driving call ends, so a LATER call with a fresh scheduler
    re-attaches instead of pumping a stale loop."""
    attached = []
    if scheduler is None:
        return attached
    for o in oracles:
        if (o is not None and getattr(o, "scheduler", None) is None
                and getattr(o, "engine", None) is scheduler.engine):
            o.scheduler = scheduler
            attached.append(o)
    return attached


def detach_scheduler(attached: Sequence) -> None:
    for o in attached:
        o.scheduler = None


def attach_memo(oracles: Sequence, memo) -> list:
    """Point each deferred-capable oracle without a memo of its own at the
    shared :class:`~repro_torch.core.oracles.cache.SemanticMemo`.  Returns the
    oracles actually attached — pass to :func:`detach_memo` when the
    driving call ends (the memo itself outlives the call; only the
    attachment is scoped)."""
    attached = []
    if memo is None:
        return attached
    for o in oracles:
        if (o is not None and hasattr(o, "begin_probe_round")
                and getattr(o, "memo", None) is None):
            o.memo = memo
            attached.append(o)
    return attached


def detach_memo(attached: Sequence) -> None:
    for o in attached:
        o.memo = None


def auto_scheduler(oracles: Sequence):
    """Build a shared probe queue (``BatchScheduler``) when every
    deferred-capable oracle in ``oracles`` rides one engine; None otherwise
    (plans still interleave tick-by-tick, rounds resolve synchronously
    per plan)."""
    engines = {}
    drafts = {}
    for o in oracles:
        if (hasattr(o, "begin_probe_round")
                and getattr(o, "engine", None) is not None):
            engines[id(o.engine)] = o.engine
            d = getattr(o, "draft_engine", None)
            if d is not None:
                drafts[id(d)] = d
    if len(engines) != 1 or len(drafts) > 1:
        return None
    from ..serving.scheduler import BatchScheduler
    (engine,) = engines.values()
    return BatchScheduler(engine,
                          draft_engine=next(iter(drafts.values()), None))


# ----------------------------------------------------------------- results
def plan_sort_result(run: PlanRun, spec: SortSpec, n_keys: int,
                     prices) -> SortResult:
    """Build the :class:`SortResult` a solo ``AccessPath.execute`` would
    have returned, from a finished plan's output and per-plan records."""
    if run.error is not None:
        raise run.error
    view = LedgerView(list(run.records))
    k = spec.effective_limit(n_keys)
    return SortResult(
        order=list(run.result)[:k],
        path=run.path.name if run.path is not None else run.name,
        params=run.path.describe_params() if run.path is not None else {},
        n_calls=view.n_calls, input_tokens=view.input_tokens,
        output_tokens=view.output_tokens, cost=view.cost(prices),
    )
