"""The LLM ORDER BY logical operator — public entry point.

``llm_order_by(keys, criteria, oracle, ...)`` mirrors the paper's SQL surface:

    SELECT id, text FROM reviews
    LLM_ORDER_BY(text, 'degree of positivity') DESC LIMIT 10;

``path="auto"`` routes through the budget-aware optimizer; any registry name
("pointwise", "ext_merge", ...) forces a static access path.

``llm_order_by_many(queries)`` executes several ORDER BY queries
*concurrently* over one serving stack: each query's access path runs as a
resumable probe plan, and every scheduling tick merges the ready probes of
all queries into shared serving submissions (with cross-query dedup of
identical prompts).  Per-query results and ledgers are byte-identical to
running each query solo.  ``path="auto"`` queries ride the same tick
stream: their optimizer pipeline runs as an incremental driver on the
shared executor, under per-query admission control.

Counterpart of ``src/repro/core/operator.py`` (copied; only imports and
cross-references point at the port)."""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence

from .access_paths.base import PathParams, make_path
from .executor import (ProbePlanExecutor, attach_memo, attach_scheduler,
                       auto_scheduler, detach_memo, detach_scheduler,
                       plan_sort_result)
from .optimizer.cost_model import CandidateSpec
from .optimizer.optimizer import (AccessPathOptimizer, OptimizerConfig,
                                  OptimizerDriver, OptimizerReport)
from .types import Key, SortResult, SortSpec
from .oracles.base import Oracle


def llm_order_by(keys: Sequence[Key], criteria: str, oracle: Oracle, *,
                 descending: bool = False, limit: Optional[int] = None,
                 path: str = "auto", params: Optional[PathParams] = None,
                 budget: Optional[float] = None, strategy: str = "borda",
                 sample_size: int = 20,
                 judge_oracle: Optional[Oracle] = None,
                 candidates: Optional[list[CandidateSpec]] = None,
                 ladder_thresholds: Optional[Sequence[float]] = None,
                 ) -> tuple[SortResult, Optional[OptimizerReport]]:
    """Execute LLM ORDER BY; returns (result, optimizer_report_or_None).

    ``ladder_thresholds``: cascade escalation thresholds for a
    :class:`~repro_torch.core.oracles.cascade.CascadeOracle`-style backend —
    ``path="auto"`` then also explores draft-first cascade variants of
    every candidate path (ignored for oracles without ``at_threshold``)."""
    spec = SortSpec(criteria=criteria, descending=descending, limit=limit)
    if path != "auto":
        ap = make_path(path, params or PathParams())
        return ap.execute(keys, oracle, spec), None
    opt = AccessPathOptimizer(
        OptimizerConfig(sample_size=sample_size, budget=budget, strategy=strategy,
                        ladder_thresholds=ladder_thresholds),
        candidates=candidates,
    )
    result, report = opt.choose_and_execute(keys, oracle, spec, judge_oracle=judge_oracle)
    return result, report


@dataclass
class OrderQuery:
    """One concurrent LLM ORDER BY query for :func:`llm_order_by_many`.

    Each query carries its OWN oracle so per-query billing stays exact;
    oracles may (and for serving-level coalescing should) share one
    engine — e.g. one ``ModelOracle(engine)`` per query.

    ``path="auto"`` runs the full optimizer pipeline for this query on the
    SHARED executor (see :class:`~repro_torch.core.optimizer.optimizer.OptimizerDriver`);
    ``budget``/``strategy``/``sample_size``/``judge_oracle``/``candidates``
    mirror :func:`llm_order_by`'s optimizer knobs and are ignored for
    static paths.  After :func:`llm_order_by_many` returns, an auto
    query's ``report`` field holds its :class:`OptimizerReport`.

    ``tenant`` names the priority class every serving-level submission of
    this query is billed to (see
    :class:`~repro_torch.serving.scheduler.TenantSpec`)."""

    keys: Sequence[Key]
    criteria: str
    oracle: Oracle
    descending: bool = False
    limit: Optional[int] = None
    path: str = "quick"
    params: Optional[PathParams] = None
    budget: Optional[float] = None
    strategy: str = "borda"
    sample_size: int = 20
    judge_oracle: Optional[Oracle] = None
    candidates: Optional[list[CandidateSpec]] = None
    ladder_thresholds: Optional[Sequence[float]] = None
    tenant: str = "default"
    report: Optional[OptimizerReport] = None


def llm_order_by_many(queries: Sequence[OrderQuery], *,
                      scheduler=None, semantic_memo=None,
                      prefetch: Optional[bool] = None) -> list[SortResult]:
    """Execute several LLM ORDER BY queries concurrently over one engine.

    All queries' access-path plans advance together through a
    :class:`~repro_torch.core.executor.ProbePlanExecutor`: each scheduling tick
    gathers the ready probe sets of every suspended plan and — on a
    ModelOracle backend sharing one engine — merges them into shared
    length-bucketed serving submissions, deduplicating identical prompts
    across queries.  Results are aligned with ``queries``; each
    ``SortResult``'s order AND accounting are ``==``-identical to running
    that query alone (the executor tracks per-plan ledger records).

    ``semantic_memo``: a shared
    :class:`~repro_torch.core.oracles.cache.SemanticMemo` (or ``True`` for a
    fresh one) consulted by every deferred-capable oracle before emitting
    per-item probes — comparisons, pointwise scores, inquiries already
    answered for ANOTHER query (or an earlier call reusing the memo) are
    served from the memo instead of the backend.  Billing becomes
    first-requester-pays: a hit query's ``SortResult`` accounting shows
    only what it was billed, and ``oracle.reconciled_records()`` rebuilds
    its solo ledger byte-identically.  Orderings are unchanged either way
    (memo values are the raw probe results the query's own probes would
    have produced).  Default ``None``: no memo, per-query ledgers stay
    solo-identical.

    ``prefetch``: forwards to
    :class:`~repro_torch.core.executor.ProbePlanExecutor` — ``None`` (default)
    enables prefix-region prefetch pipelining whenever a scheduler is in
    play; ``False`` pins the reactive fill-on-demand behavior (the
    benchmarks' baseline).

    ``path="auto"`` queries run their WHOLE optimizer pipeline — the
    membership gate, every pilot, selection, and the winner's full
    execution — as plans on this same shared executor via one
    :class:`~repro_torch.core.optimizer.optimizer.OptimizerDriver` per query, so
    optimizer probe rounds co-schedule with every other query's.  Each
    driver's budget arithmetic reads only its own oracle's ledger, so
    per-query admission control (and the final report) matches a solo
    :func:`llm_order_by` run byte-for-byte."""
    from .oracles.cache import SemanticMemo
    oracles = [q.oracle for q in queries]
    judges = [q.judge_oracle for q in queries if q.judge_oracle is not None]
    if scheduler is None:
        scheduler = auto_scheduler(oracles + judges)
    if semantic_memo is True:
        semantic_memo = SemanticMemo()
    # every query's oracle becomes a client of the SAME live loop FOR THIS
    # CALL: deferred probe rounds ride its step gaps, and any generation
    # the oracle runs (judge rationales) decodes through it — so probes
    # and rationale tokens co-schedule instead of alternating whole
    # drains.  The attachment is scoped (restored on exit) so a later call
    # with a fresh scheduler re-attaches instead of pumping a stale loop;
    # the memo attachment is scoped the same way (the memo itself is the
    # caller's and outlives the call — cross-CALL reuse is the point).
    # Tenant tags are scoped identically: each query's oracle bills its
    # serving-level rounds to the query's priority class for this call.
    attached = attach_scheduler(oracles + judges, scheduler)
    attached_memo = attach_memo(oracles, semantic_memo)
    _MISSING = object()
    tenant_saved = []
    for q in queries:
        for o in (q.oracle, q.judge_oracle):
            if o is not None and q.tenant != "default":
                tenant_saved.append((o, getattr(o, "tenant", _MISSING)))
                o.tenant = q.tenant
    try:
        ex = ProbePlanExecutor(scheduler=scheduler, prefetch=prefetch)
        runs = []
        for i, q in enumerate(queries):
            spec = SortSpec(q.criteria, q.descending, q.limit)
            if q.path == "auto":
                opt = AccessPathOptimizer(
                    OptimizerConfig(sample_size=q.sample_size,
                                    budget=q.budget, strategy=q.strategy,
                                    ladder_thresholds=q.ladder_thresholds),
                    candidates=q.candidates)
                runs.append((q, spec, OptimizerDriver(
                    opt, list(q.keys), q.oracle, spec,
                    judge_oracle=q.judge_oracle, executor=ex,
                    tenant=q.tenant, name=f"q{i}:auto")))
            else:
                ap = make_path(q.path, q.params or PathParams())
                runs.append((q, spec, ex.submit_path(
                    ap, q.keys, q.oracle, spec, name=f"q{i}:{q.path}",
                    tenant=q.tenant)))
        drivers = [r for _q, _s, r in runs if isinstance(r, OptimizerDriver)]
        if drivers:
            def on_tick(_ex) -> None:
                for d in drivers:
                    d.on_tick(_ex)
            ex.run(on_tick=on_tick)
        else:
            ex.run()
        out = []
        for q, spec, r in runs:
            if isinstance(r, OptimizerDriver):
                q.report = r.report
                out.append(r.result)
            else:
                out.append(plan_sort_result(r, spec, len(q.keys),
                                            q.oracle.prices))
        return out
    finally:
        for o, prev in reversed(tenant_saved):
            if prev is _MISSING:
                del o.tenant
            else:
                o.tenant = prev
        detach_scheduler(attached)
        detach_memo(attached_memo)


class Table:
    """Minimal rows-of-dicts relation so examples read like the paper's SQL."""

    def __init__(self, rows: Sequence[dict]):
        self.rows = list(rows)

    def llm_order_by(self, column: str, criteria: str, oracle: Oracle,
                     latent_column: Optional[str] = None, **kw
                     ) -> tuple[list[dict], SortResult, Optional[OptimizerReport]]:
        keys = [
            Key(uid=i, text=str(r[column]),
                latent=float(r[latent_column]) if latent_column else float("nan"))
            for i, r in enumerate(self.rows)
        ]
        result, report = llm_order_by(keys, criteria, oracle, **kw)
        ordered_rows = [self.rows[k.uid] for k in result.order]
        return ordered_rows, result, report
