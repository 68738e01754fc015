"""The budget-aware access-path optimizer (Sec. 5).

Pipeline (choose_and_execute):
  1. draw a deterministic sample of ``sample_size`` keys;
  2. **world-knowledge gate + pilot runs** — one probe-plan executor drives
     the Inquiry-Prompt round (Sec. 5.2) AND every candidate's sample run
     *concurrently*: the gate's inquiries ride the same scheduling tick as
     the candidates' first rounds, and on a ModelOracle backend all plans'
     probes merge into shared serving submissions instead of the pilots
     starving the engine between each candidate's rounds.  100% membership
     cancels the pilots and executes pointwise directly (the speculative
     first pilot rounds are the price of overlapping the gate with
     sampling); otherwise each surviving candidate's sampled cost and
     sample ranking come from its per-plan ledger slice
     (failed/structurally-invalid candidates are dropped);
  4. **cost extrapolation** — scale sampled cost by the Table-1 complexity
     ratio; filter candidates whose estimated full-run cost violates the
     user budget (Sec. 5.1/5.3, Fig. 5);
  5. **selection** — 'judge' (optimistic, Sec. 5.4; the judge's candidate
     probes ride one batched submission on the ModelOracle), 'borda'
     (pessimistic, Sec. 5.5), or 'oracle' (ground-truth upper-bound used in
     Table 3);
  6. execute the winner once over the full dataset.

Budget-capped sampling under concurrency: with no budget every candidate is
admitted at tick 1 (maximum merging).  With a budget, sampling must be
spend-observed — the FIRST candidate is still admitted cheapest-first and
run to completion so the cost model can calibrate.  From then on admission
is *predictive*: completed pilots yield a measured $/est_call rate
(``cost_model.dollars_per_est_call``), each remaining candidate's sample
spend is predicted as ``est_calls x rate`` (``predict_sample_cost``), and
additional pilots are co-admitted while observed spend plus every
in-flight candidate's FULL prediction stays under
``budget * sampling_fraction`` — overlapped pilots merge their probe
rounds into shared serving submissions, and cap overshoot is bounded by
prediction error instead of whole in-flight pilots (regression-pinned in
tests/test_optimizer.py).  ``pilot_overlap=False`` restores the strictly
serial wait-for-each-pilot semantics.  Once spend crosses the cap with at
least one successful sample, the rest are dropped ("sampling-budget").
The gate round always overlaps the first candidate.

Counterpart of ``src/repro/core/optimizer/optimizer.py`` (copied; only imports and
cross-references point at the port)."""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Optional, Sequence

import numpy as np

from ..access_paths.base import Ordering
from ..executor import (PlanCancelled, ProbePlanExecutor, attach_scheduler,
                        auto_scheduler, detach_scheduler, plan_sort_result)
from ..metrics import kendall_tau, kendall_tau_between, ndcg_between, ndcg_at_k
from ..types import Key, SortResult, SortSpec
from ..oracles.base import LedgerView, Oracle
from .borda import borda_consensus
from .cost_model import (CandidateSpec, default_candidates,
                         dollars_per_est_call, est_sample_calls,
                         estimate_full_cost, ladder_candidates,
                         predict_sample_cost)
from .judge import judge_select
from .membership import membership_plan

COMPARISON_KINDS = ("quick", "ext_bubble", "ext_merge")


@dataclass
class OptimizerConfig:
    sample_size: int = 20
    budget: Optional[float] = None
    # "borda" | "judge" | "oracle" pick ONE path (the paper's optimizer);
    # "consensus" (beyond-paper) executes the top-``consensus_k`` affordable
    # candidates on the full dataset and Borda-merges their output rankings —
    # trading surplus budget for ensemble robustness at execution time.
    strategy: str = "borda"
    consensus_k: int = 2
    membership_threshold: float = 1.0
    # Budget-filter safety margins (beyond-paper hardening).  The paper notes
    # (Sec. 6.3) that an underestimated algorithm "can lead to a direct
    # violation of the user's budget constraint" — and quick-sort-family
    # estimates indeed run ~2x low under noisy comparators (deferred-vote
    # rounds + deeper recursion are invisible at sample scale).  Estimates
    # are reported raw; filtering multiplies them by these factors.
    safety_comparison: float = 2.0
    safety_value: float = 1.1
    # Sampling may consume at most this fraction of the budget (candidates
    # are sampled cheapest-first; the rest are dropped unsampled).  Without
    # this, a tight budget is blown during stage 2 before anything executes.
    sampling_fraction: float = 0.35
    # Predictive pilot overlap under a budget: once one pilot has completed
    # (calibrating a measured $/est_call rate), additional pilots are
    # co-admitted while observed spend + Σ in-flight predictions stays
    # under the sampling cap.  False restores strictly serial sampling
    # (admit one, wait for its full observed cost).
    pilot_overlap: bool = True
    # Model-cascade ladder (core/oracles/cascade.py): when the oracle
    # supports ``at_threshold`` and thresholds are given, the candidate
    # pool is expanded with a cascade variant of every path per threshold
    # — the optimizer then picks a (path, rung, threshold) tuple under
    # the same budget, with $/est_call calibrated per rung.  Ignored for
    # oracles without a cascade ladder.
    ladder_thresholds: Optional[Sequence[float]] = None
    seed: int = 0


@dataclass
class OptimizerReport:
    chosen: Optional[CandidateSpec] = None
    reason: str = ""
    membership_rate: float = 0.0
    sample_uids: list = field(default_factory=list)
    sample_results: dict = field(default_factory=dict)   # label -> SortResult
    est_costs: dict = field(default_factory=dict)        # label -> $ estimate
    sample_scores: dict = field(default_factory=dict)    # label -> selection score
    in_budget: list = field(default_factory=list)
    dropped: list = field(default_factory=list)          # (label, why)
    optimizer_cost: float = 0.0
    execution_cost: float = 0.0
    # peak number of pilot candidates in flight in one tick — > 1 under a
    # budget means predictive overlap engaged (no-budget runs admit all)
    max_concurrent_pilots: int = 0

    @property
    def total_cost(self) -> float:
        return self.optimizer_cost + self.execution_cost


class AccessPathOptimizer:
    def __init__(self, config: OptimizerConfig = OptimizerConfig(),
                 candidates: Optional[list[CandidateSpec]] = None):
        self.config = config
        self.candidates = candidates if candidates is not None else default_candidates()

    # ------------------------------------------------------------------ utils
    def _sample(self, keys: Sequence[Key]) -> list[Key]:
        s = min(self.config.sample_size, len(keys))
        rng = np.random.default_rng(self.config.seed)
        idx = rng.choice(len(keys), size=s, replace=False)
        return [keys[i] for i in sorted(idx)]

    @staticmethod
    def _rank_similarity(candidate: SortResult, gold_uids: list[int],
                         spec: SortSpec) -> float:
        """kendall tau for full sorts, nDCG@K for LIMIT-K queries — matching
        the benchmark's own objective (Sec. 6.1)."""
        uids = candidate.uids()
        if spec.limit is not None:
            return ndcg_between(uids, gold_uids, k=spec.limit)
        return kendall_tau_between(uids, gold_uids)

    # ------------------------------------------------------------- selection
    def _select(self, pool: list[CandidateSpec], sample: list[Key],
                spec: SortSpec, report: OptimizerReport,
                judge_oracle: Oracle) -> CandidateSpec:
        if len(pool) == 1:
            if not report.reason:
                report.reason = "single-candidate"
            return pool[0]
        strategy = self.config.strategy

        if strategy == "judge":
            orders = [report.sample_results[c.label].order for c in pool]
            win = judge_select(sample, spec.criteria, orders, judge_oracle)
            report.reason = "judge"
            return pool[int(win)]

        if strategy == "oracle":
            # ground-truth selection (Table 3 upper bound): best sample metric
            best, best_v = pool[0], -math.inf
            for c in pool:
                order = report.sample_results[c.label].order
                if spec.limit is not None:
                    from ..metrics import graded_relevance
                    rel = graded_relevance(sample, descending=spec.descending)
                    v = ndcg_at_k(order, rel, k=min(spec.limit, len(sample)))
                else:
                    v = kendall_tau(order, descending=spec.descending)
                report.sample_scores[c.label] = v
                if v > best_v:
                    best, best_v = c, v
            report.reason = "oracle"
            return best

        # default: pessimistic Borda consensus (Sec. 5.5)
        ballots = [report.sample_results[c.label].uids()
                   for c in pool if c.comparison_based]
        if not ballots:  # all-value-based pool (e.g. tight budget): best vs each other
            ballots = [report.sample_results[c.label].uids() for c in pool]
        universe = [k.uid for k in sample]
        gold = borda_consensus(ballots, universe)
        best, best_v = pool[0], -math.inf
        for c in pool:
            v = self._rank_similarity(report.sample_results[c.label], gold, spec)
            report.sample_scores[c.label] = v
            if v > best_v:
                best, best_v = c, v
        report.reason = "borda"
        return best

    # ------------------------------------------------------------- main entry
    def choose_and_execute(self, keys: Sequence[Key], oracle: Oracle,
                           spec: SortSpec,
                           judge_oracle: Optional[Oracle] = None,
                           scheduler=None
                           ) -> tuple[SortResult, OptimizerReport]:
        """Run the whole pipeline on a private executor.  This is a thin
        wrapper over :class:`OptimizerDriver` — the SAME incremental code
        path ``llm_order_by_many(path="auto")`` drives on its shared
        executor — so a solo auto query and one riding a many-query tick
        stream produce byte-identical ledgers by construction."""
        keys = list(keys)
        sched = scheduler if scheduler is not None else auto_scheduler([oracle])
        # the pilot phase drives the SAME live serving loop everything else
        # rides: deferred rounds resolve in its step gaps, and any
        # oracle-side generation (judge rationales) co-schedules with them.
        # Scoped to this call — detached in the finally below, so repeat
        # optimizations never pump a stale loop.
        attached = attach_scheduler([oracle, judge_oracle], sched)
        try:
            ex = ProbePlanExecutor(scheduler=sched)
            driver = OptimizerDriver(self, keys, oracle, spec,
                                     judge_oracle=judge_oracle, executor=ex)
            ex.run(on_tick=driver.on_tick)
            return driver.result, driver.report
        finally:
            detach_scheduler(attached)


class OptimizerDriver:
    """The optimizer pipeline as an incremental driver over an EXTERNAL
    :class:`~repro_torch.core.executor.ProbePlanExecutor`.

    Every stage that used to block — waiting for the pilots, then
    executing the winner synchronously — is instead advanced from
    ``on_tick``: the membership gate and pilot plans are submitted up
    front, each tick runs the budget-capped admission policy (the
    docstring at the top of this module), and once the pilots settle the
    selection stages run inline and the winner is submitted as one more
    plan on the same executor.  ``llm_order_by_many`` gives each auto
    query its own driver on ONE shared executor, so N optimizer queries'
    pilot rounds (and full executions) merge into the same serving
    submissions as everything else — per-query admission control is just
    each driver's own cap arithmetic over its own oracle's ledger."""

    def __init__(self, opt: AccessPathOptimizer, keys: Sequence[Key],
                 oracle: Oracle, spec: SortSpec,
                 judge_oracle: Optional[Oracle] = None, executor=None,
                 tenant: str = "default", name: str = "auto"):
        cfg = opt.config
        self.opt = opt
        self.cfg = cfg
        self.keys = list(keys)
        self.oracle = oracle
        self.spec = spec
        self.judge_oracle = judge_oracle
        self.ex = executor
        self.tenant = tenant
        self.name = name
        self.report = OptimizerReport()
        self.snap = oracle.ledger.snapshot()
        self.sample = opt._sample(self.keys)
        self.report.sample_uids = [k.uid for k in self.sample]
        # stages 1+2: gate + pilot candidates on the shared executor — the
        # gate's inquiry round and every candidate's sample run advance
        # together, their ready probes merging into shared serving drains.
        self.sample_spec = SortSpec(spec.criteria, spec.descending,
                                    None if spec.limit is None
                                    else min(spec.limit, len(self.sample)))
        self.k_s = (None if spec.limit is None
                    else min(spec.limit, len(self.sample)))
        self.sample_cap = (None if cfg.budget is None
                           else cfg.budget * cfg.sampling_fraction)
        pool = opt.candidates
        if cfg.ladder_thresholds and hasattr(oracle, "at_threshold"):
            pool = ladder_candidates(pool, list(cfg.ladder_thresholds))
        self.backlog = sorted(
            pool,
            key=lambda c: est_sample_calls(c, len(self.sample), self.k_s))
        self.pilots: list[tuple[CandidateSpec, object]] = []
        # rate$ is the global $/est_call calibration; rung$ holds per-rung
        # rates (cascade rungs run cheaper per call than large-only)
        self.state: dict = {"member": False, "rate$": None, "rung$": {}}
        self.gate = self.ex.submit_plan(
            membership_plan(self.sample), Ordering(oracle, spec),
            name=f"{name}:membership", tenant=tenant)
        # no budget: every pilot rides the gate's tick; budget: cheapest
        # rides it, the rest are admitted predictively while under the cap
        self._admit(len(self.backlog) if self.sample_cap is None else 1)
        self.phase = "pilots"
        self.exec_runs: list = []
        self._consensus_take: list[CandidateSpec] = []
        self._consensus_queue: list[CandidateSpec] = []
        self.result: Optional[SortResult] = None
        self.done = False

    # ------------------------------------------------------------- helpers
    def _oracle_for(self, cand: CandidateSpec) -> Oracle:
        """The oracle a candidate's plans run on: a cascade rung view for
        ladder candidates (shared ledger/engines, so _spent() still sees
        every dollar), the base oracle otherwise."""
        if cand.threshold is None:
            return self.oracle
        return self.oracle.at_threshold(cand.threshold)

    def _admit(self, n: int) -> None:
        while self.backlog and n > 0:
            cand = self.backlog.pop(0)
            self.pilots.append((cand, self.ex.submit_path(
                cand.make(), self.sample, self._oracle_for(cand),
                self.sample_spec, name=cand.label, tenant=self.tenant)))
            n -= 1

    def _spent(self) -> float:
        return self.oracle.ledger.since(self.snap).cost(self.oracle.prices)

    def _sampled_cost(self, run) -> float:
        return LedgerView(list(run.records)).cost(self.oracle.prices)

    def _predicted(self, cand) -> float:
        # per-rung rate when that rung has a completed pilot, else the
        # global rate — a cascade rung's first pilot is predicted off the
        # pooled rate (conservative: large-only rates overestimate it)
        rate = self.state["rung$"].get(cand.rung, self.state["rate$"])
        return predict_sample_cost(cand, len(self.sample), self.k_s, rate)

    def _submit_exec(self, cand: CandidateSpec) -> None:
        self.exec_runs.append(self.ex.submit_path(
            cand.make(), self.keys, self._oracle_for(cand), self.spec,
            name=f"{self.name}:exec:{cand.label}", tenant=self.tenant))

    # ---------------------------------------------------------------- tick
    def on_tick(self, _ex=None) -> None:
        if self.done:
            return
        if self.phase == "pilots":
            self._pilot_tick()
            if (self.gate.done and not self.backlog
                    and all(r.done for _c, r in self.pilots)):
                self._transition()
        if self.phase == "execute" and all(r.done for r in self.exec_runs):
            if self._consensus_queue:     # serial consensus chain
                self._submit_exec(self._consensus_queue.pop(0))
            else:
                self._finish()

    def _pilot_tick(self) -> None:
        cfg, report, state = self.cfg, self.report, self.state
        report.max_concurrent_pilots = max(
            report.max_concurrent_pilots,
            sum(1 for _c, r in self.pilots if not r.done))
        if self.gate.done and "rate" not in state:
            if self.gate.error is not None:
                # a structurally failing gate propagated before the
                # executor refactor; keep that contract rather than
                # reading a silent 0.0 membership rate
                raise self.gate.error
            state["rate"] = self.gate.result
            report.membership_rate = state["rate"]
            if state["rate"] >= cfg.membership_threshold:
                state["member"] = True           # Sec. 5.2 short-circuit
                for _c, run in self.pilots:
                    run.cancel("membership short-circuit")
                self.backlog.clear()
                return
        if self.sample_cap is None or not self.backlog:
            return
        # Budget-capped sampling is spend-observed: the cap check sees
        # completed pilots' full sampled costs, and once spend crosses
        # the cap with one successful sample the rest are dropped.
        spent_now = self._spent()
        succeeded = any(r.done and r.error is None for _c, r in self.pilots)
        inflight = [(c, r) for c, r in self.pilots if not r.done]
        if spent_now >= self.sample_cap and succeeded:
            for cand in self.backlog:
                report.dropped.append((cand.label, "sampling-budget"))
            self.backlog.clear()
            return
        # serial floor (exactly the pre-overlap semantics): with
        # nothing in flight and headroom left, admit the next cheapest
        # regardless of prediction — prediction may only ADD overlap,
        # never starve a candidate the serial policy would have sampled
        if not inflight:
            self._admit(1)
            inflight = [self.pilots[-1]]
        if not cfg.pilot_overlap:
            return
        # predictive overlap: calibrate $/est_call on completed pilots,
        # then co-admit while observed spend + every in-flight
        # candidate's FULL predicted sample cost fits under the cap —
        # overshoot is bounded by prediction error, not by whole
        # in-flight pilots (ROADMAP "budgeted-pilot overlap")
        completed = [(c, self._sampled_cost(r)) for c, r in self.pilots
                     if r.done and r.error is None]
        state["rate$"] = dollars_per_est_call(
            completed, len(self.sample), self.k_s)
        rungs = {c.rung for c, _cost in completed}
        state["rung$"] = {
            rung: dollars_per_est_call(
                [(c, cost) for c, cost in completed if c.rung == rung],
                len(self.sample), self.k_s)
            for rung in rungs}
        if state["rate$"] is None:
            return                          # uncalibrated: stay serial
        committed = spent_now + sum(self._predicted(c) for c, _r in inflight)
        while (self.backlog
               and committed + self._predicted(self.backlog[0])
               <= self.sample_cap):
            committed += self._predicted(self.backlog[0])
            self._admit(1)

    # -------------------------------------------------- stages 3-5 inline
    def _transition(self) -> None:
        cfg, report = self.cfg, self.report
        self.phase = "execute"
        if self.state["member"]:
            report.chosen = CandidateSpec("pointwise")
            report.reason = "membership"
            report.optimizer_cost = self._spent()
            self._submit_exec(report.chosen)
            return
        alive: list[CandidateSpec] = []
        for cand, run in self.pilots:
            if run.error is not None:
                why = (str(run.error) if isinstance(run.error, PlanCancelled)
                       else f"invalid-output: {run.error}")
                report.dropped.append((cand.label, why))
                continue
            # the run's per-plan ledger slice IS its sampled cost — identical
            # records to a solo execute() of the same candidate
            res = plan_sort_result(run, self.sample_spec, len(self.sample),
                                   self.oracle.prices)
            report.sample_results[cand.label] = res
            est = estimate_full_cost(cand, res.cost, len(self.sample),
                                     len(self.keys), self.spec.limit)
            report.est_costs[cand.label] = est
            alive.append(cand)

        # -- stage 3: budget filter ---------------------------------------
        spent = self._spent()
        in_budget = []
        for cand in alive:
            est = report.est_costs[cand.label]
            margin = (cfg.safety_comparison if cand.comparison_based
                      else cfg.safety_value)
            if cfg.budget is not None and spent + est * margin > cfg.budget:
                report.dropped.append(
                    (cand.label, f"over-budget est=${est:.3f}x{margin:g}"))
            else:
                in_budget.append(cand)
        if not in_budget and alive:
            # nothing affordable: degrade to the cheapest estimate
            cheapest = min(alive, key=lambda c: report.est_costs[c.label])
            in_budget = [cheapest]
            report.reason = "budget-forced-cheapest"
        report.in_budget = [c.label for c in in_budget]
        if not in_budget:
            raise RuntimeError("no runnable candidate access path")

        # -- stage 4: selection ---------------------------------------------
        if cfg.strategy == "consensus":
            self._consensus_transition(in_budget, spent)
            return
        chosen = self.opt._select(
            in_budget, self.sample, self.spec, report,
            self.judge_oracle if self.judge_oracle is not None
            else self.oracle)
        report.chosen = chosen
        report.optimizer_cost = self._spent()
        # -- stage 5: full execution rides the shared executor --------------
        self._submit_exec(chosen)

    def _consensus_transition(self, pool: list, spent: float) -> None:
        """Beyond-paper consensus: rank the affordable pool by sample-level
        Borda agreement, then execute the top-k serially (each full run is
        one plan; the next is submitted when the previous finishes, so the
        shared ledger's record order matches the old synchronous loop) and
        Borda-merge their outputs in :meth:`_finish`."""
        cfg, report = self.cfg, self.report
        ranked_pool = list(pool)
        if len(pool) > 1:
            ballots = [report.sample_results[c.label].uids()
                       for c in pool if c.comparison_based] or \
                      [report.sample_results[c.label].uids() for c in pool]
            gold = borda_consensus(ballots, [k.uid for k in self.sample])
            scores = {c.label: self.opt._rank_similarity(
                report.sample_results[c.label], gold, self.spec)
                for c in pool}
            report.sample_scores.update(scores)
            ranked_pool.sort(key=lambda c: -scores[c.label])
        # greedily take candidates while the budget holds
        take: list[CandidateSpec] = []
        est_sum = 0.0
        for c in ranked_pool:
            est = report.est_costs[c.label]
            if len(take) < cfg.consensus_k and (
                    cfg.budget is None
                    or spent + est_sum + est <= cfg.budget):
                take.append(c)
                est_sum += est
        if not take:
            take = [ranked_pool[0]]
        report.chosen = take[0]
        report.reason = "consensus:" + "+".join(c.label for c in take)
        report.optimizer_cost = spent
        self._consensus_take = take
        self._consensus_queue = take[1:]
        self._submit_exec(take[0])

    def _finish(self) -> None:
        report = self.report
        results = [plan_sort_result(run, self.spec, len(self.keys),
                                    self.oracle.prices)
                   for run in self.exec_runs]
        report.execution_cost = sum(r.cost for r in results)
        if len(results) == 1:
            self.result = results[0]
        else:                             # consensus Borda merge
            universe = [k.uid for k in self.keys]
            merged_uids = borda_consensus([r.uids() for r in results],
                                          universe)
            by_uid = {k.uid: k for k in self.keys}
            k_eff = self.spec.effective_limit(len(self.keys))
            self.result = SortResult(
                order=[by_uid[u] for u in merged_uids[:k_eff]],
                path="consensus(" + "+".join(r.path for r in results) + ")",
                n_calls=sum(r.n_calls for r in results),
                input_tokens=sum(r.input_tokens for r in results),
                output_tokens=sum(r.output_tokens for r in results),
                cost=report.execution_cost,
            )
        self.done = True
