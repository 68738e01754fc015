"""Unified token-granularity serving loop: ONE step loop over a typed
work queue, co-scheduling decode rows, probe rounds, and prefix fills.

``BatchScheduler`` owns a single admission queue of typed work items:

 * **decode work** (``submit`` / ``generate`` / ``run``) — prefill + greedy
   decode rows that live across many steps in the paged pool;
 * **probe work** (``submit_probe`` / ``submit_probe_round``) — single-token
   read-out prefills (score / compare / yes-no) that complete the step they
   are serviced in; a *round* groups the probes of one oracle round behind a
   :class:`RoundFuture` that resolves when every member has logits;
 * **prefix-fill work** (``submit_prefix_fill``) — prefix-KV region
   prefills scheduled ahead of need, so a round's shared prefix can be
   warmed in a step gap while decode rows keep streaming.

Every :meth:`step` runs one pass of the admission policy and ONE decode
step: queued decode items are admitted FIFO into free pool/row capacity,
then ALL pending fills and probe work are serviced (probe submissions ride
the step gap — merged across submitters into length-bucketed submissions
with identical prompts deduplicated), then every active decode row advances
one token and retiring rows free their blocks.  The ordering gives both
fairness bounds by construction: a probe round submitted at any point is
answered before the NEXT decode step (a long rationale cannot delay it by
more than one step), and a probe storm cannot stall decode rows because
each step decodes exactly once regardless of probe volume.

Clients of the loop:

 * ``run()`` drains the scheduler's own backlog by pumping :meth:`step`
   until no decode work remains (``on_step`` fires between steps and may
   submit more work mid-drain);
 * ``generate()`` submits rows and pumps until THOSE rows finish — queued
   probe rounds and other drivers' rows advance alongside, which is how a
   judge rationale generation co-schedules with ORDER BY probes;
 * the probe-plan executor (``core/executor.py``) begins every suspended
   plan's deferred round (``ModelOracle.begin_probe_round`` →
   ``submit_probe_round``) and pumps ONE step — all plans' probes land in
   that step's gap, and their futures resolve between decode steps.

**Multi-tenant serving**: every work item carries a tenant name, and
registered :class:`TenantSpec`s turn the admission policy into a weighted
one — decode admission walks tenants by priority (FIFO within a tenant,
head-of-line protection across priority levels), per-class
``reserved_rows`` are held back from lower classes while a reserved tenant
has queued decode work, ``probe_quota`` bounds a tenant's probe rows per
step gap (with an aging bound so deferred rounds always drain), and
``token_budget`` rejects new submissions once a tenant's served tokens
exceed it.  When a strictly-higher-priority request cannot be admitted,
the scheduler *preempts* lower-priority preemptible rows: the engine
suspends them to a host-side stash (``ServeEngine.paged_suspend``) and
they re-enter the queue head as resumable requests whose continuation is
byte-identical (``paged_resume``).  With no tenants registered every item
is the implicit default class and the policy reduces exactly to the FIFO
loop above.  See DESIGN.md "Multi-tenant serving".

Engines without paged support (recurrent/MoE archs) fall back to
batch-level scheduling: the drain sorts the WHOLE backlog by prompt length,
chunks it into (max_batch)-sized batches, and runs each batch prefill +
lockstep decode to completion; probe work is serviced whenever the loop is
pumped (there are no step gaps to interleave into).  See DESIGN.md
"Unified step loop".

Counterpart of ``src/repro/serving/scheduler.py`` (copied; only imports and
cross-references point at the port, and the port's spans and counters
(``repro_torch.trace``) are added)."""
from __future__ import annotations

import itertools
import time
from dataclasses import dataclass, field
from typing import Callable, Optional

import numpy as np

from .. import trace
from .engine import ServeEngine
from .kv_pool import PoolExhausted

_ids = itertools.count()


# ------------------------------------------------------------ tenant classes
class TenantBudgetExceeded(RuntimeError):
    """A submission would exceed its tenant's serving-token budget."""


@dataclass(frozen=True)
class TenantSpec:
    """One tenant/priority class of the serving loop.

    ``priority`` orders admission (higher first; ties FIFO by arrival) and
    gates preemption: a waiting request may suspend active rows only of
    strictly lower-priority, ``preemptible`` classes.  ``reserved_rows``
    decode rows are withheld from OTHER classes while this tenant has
    queued decode work (a soft guarantee: liveness beats reservations when
    nothing is in flight).  ``probe_quota`` caps the tenant's probe rows
    serviced per step gap — whole rounds are deferred past the cap and
    force-serviced once they age ``starvation_bound`` steps.
    ``token_budget`` bounds SERVED tokens (decode row-steps + probe rows);
    ``ledger_budget`` bounds BILLED oracle tokens and is enforced by the
    probe-plan executor (core/executor.py), which cancels the tenant's
    plans once their ledger slices exceed it."""
    name: str
    priority: int = 0
    reserved_rows: int = 0
    probe_quota: Optional[int] = None
    token_budget: Optional[int] = None
    ledger_budget: Optional[int] = None
    preemptible: bool = True


_DEFAULT_TENANT = TenantSpec("default")


@dataclass
class TenantStats:
    """Per-tenant serving accounting (scheduler-side; the engine-side
    preemption/starvation counters live in ``ServeStats``).  Billing
    convention for preempted rows: ``tokens_served`` charges one token per
    ACTIVE owned row per decode step, so a suspended row is not billed
    while parked and a suspend/resume cycle bills exactly the tokens a
    never-preempted run would — no double-billing."""
    submitted: int = 0
    admitted: int = 0
    finished: int = 0
    preemptions: int = 0
    resumes: int = 0
    probe_rows: int = 0
    rounds_serviced: int = 0
    tokens_served: int = 0
    max_admission_wait: int = 0   # steps a decode item waited, worst case
    max_round_wait: int = 0       # steps a probe unit was deferred, worst case


# ------------------------------------------------------- typed work items
@dataclass
class Request:
    """Decode work: one generate request (prefill + greedy decode row).
    ``max_new`` 0 is a genuine zero budget; None means engine default."""
    rid: int
    prompt: object           # str or (shared_prefix, per_key_suffix) pair
    max_new: Optional[int]
    output: Optional[str] = None
    block_need: Optional[int] = None     # memoized KV-pool block budget
    tenant: str = "default"
    wait_steps: int = 0                  # steps spent waiting for admission
    suspended: object = None             # engine SuspendedRow when preempted

    @property
    def done(self) -> bool:
        return self.output is not None


class RoundFuture:
    """Resolves when every probe of one round has its logits.  ``result()``
    returns the logits aligned with the round's submission order."""

    __slots__ = ("_vals", "_left", "_queued_ns")

    def __init__(self, n: int):
        self._vals: list = [None] * n
        self._left = n
        # host clock at submission, taken only while a profiler records;
        # cleared when the round's wait is counted
        self._queued_ns = (time.perf_counter_ns() if trace.recording()
                           else None)

    @property
    def done(self) -> bool:
        return self._left == 0

    def _set(self, slot: int, logits) -> None:
        assert self._vals[slot] is None, "probe slot resolved twice"
        self._vals[slot] = logits
        self._left -= 1

    def result(self) -> list:
        assert self.done, "round future read before resolution"
        return self._vals


class CascadeFuture(RoundFuture):
    """Round future resolving in TWO waves inside one step gap: wave 1
    answers every slot on the draft engine, then ``escalate`` (an
    oracle-layer callback: it owns the margin rule AND the large-tier
    billing) picks the low-confidence slots, which re-run on the large
    engine before the future completes.  Clients see an ordinary
    :class:`RoundFuture` — same ``done``/``result()``, same executor
    fairness (a cascade round still resolves within one pump)."""

    __slots__ = ("escalate", "escalated")

    def __init__(self, n: int, escalate: Callable):
        super().__init__(n)
        self.escalate = escalate
        self.escalated: set = set()


@dataclass
class ProbeRequest:
    """Probe work: one single-token read-out prompt.  Stand-alone probes
    (``future is None``) deliver into ``scheduler.probe_results``; round
    members deliver into their :class:`RoundFuture` slot.  ``tier`` routes
    the probe's engine lane: "large" (the default lane) or "draft" (wave 1
    of a cascade round, served by ``draft_engine``)."""
    rid: int
    prompt: object           # str or (shared_prefix, per_key_suffix) pair
    logits: Optional[np.ndarray] = None
    future: Optional[RoundFuture] = None
    slot: int = 0
    tenant: str = "default"
    wait_steps: int = 0                  # step gaps this probe was deferred
    tier: str = "large"


@dataclass
class PrefixFill:
    """Prefix-fill work: warm the engine's prefix-KV LRU for structured
    prompts BEFORE the round or generate wave that needs them, so the fill
    submission rides an earlier step gap."""
    rid: int
    prompts: list = field(default_factory=list)   # (prefix, suffix) pairs


def _probe_key(prompt) -> tuple:
    """Dedup key for a probe prompt.  Structured pairs are keyed as-is and
    plain strings separately — the two forms produce bit-identical logits,
    but keeping them distinct makes dedup a pure no-new-bits optimization
    (a fanned-out result is exactly the result the duplicate's own
    submission row would have computed)."""
    if isinstance(prompt, str):
        return ("s", prompt)
    return ("p", tuple(prompt))


class BatchScheduler:
    def __init__(self, engine: ServeEngine, max_batch: int = 16,
                 paged: Optional[bool] = None,
                 probe_batch: Optional[int] = None,
                 starvation_bound: int = 8,
                 draft_engine: Optional[ServeEngine] = None):
        self.engine = engine
        # optional second engine lane for model-cascade probe rounds
        # (submit_cascade_round): wave-1 draft probes run here, sharing the
        # work queue but NOT the large engine's KV pool — each lane owns
        # its engine's pool/prefix cache outright
        self.draft_engine = draft_engine
        self.max_batch = max_batch
        # multi-tenant policy: specs by name; unregistered tenants (and
        # everything, when none are registered) run as the default class —
        # priority 0, no reservations, no quotas, preemptible
        self.tenants: dict[str, TenantSpec] = {}
        self.tenant_stats: dict[str, TenantStats] = {}
        # a probe unit deferred by quota this many step gaps is serviced
        # regardless; a priority-class (> 0) unit aging out, or a decode
        # item of such a class waiting past the bound, trips the
        # ServeStats starvation alarms
        self.starvation_bound = starvation_bound
        # probe drains chunk by the ENGINE's probe memory ceiling
        # (max_probe_batch), not by max_batch: probes are single-token
        # prefills, so the decode-batch cap has no bearing on them.  Pass
        # ``probe_batch`` to override.  On a sharded engine the chunk size
        # is additionally rounded up to a multiple of the engine's
        # data-shard count (:meth:`_probe_chunk`) so every chunk of a
        # sliced drain fills all shards' row slices.
        self.probe_batch = probe_batch
        # paged=None: continuous loop whenever the engine supports it;
        # False pins the lockstep batch path (the benchmark baseline)
        self.paged = (engine.paged_enabled if paged is None
                      else paged and engine.paged_enabled)
        # THE unified admission queue: typed work items in arrival order
        self.work: list = []
        self.completed: dict[int, Request] = {}
        self.probe_results: dict[int, np.ndarray] = {}
        self.probes_deduped = 0    # duplicate prompts served by fan-out
        self.probes_drafted = 0    # cascade wave-1 rows served by the draft
        self.probes_escalated = 0  # cascade rows re-run on the large engine
        self.fills_serviced = 0    # PrefixFill work items serviced
        self.regions_prefetched = 0   # prefix regions ensured resident
        self.steps = 0             # unified steps taken (decode or probe-only)
        self._rid_of_engine: dict[int, Request] = {}
        # outputs finished by step() and not yet claimed by a driver
        # (run() claims everything; generate() claims only its own rids)
        self._fresh: dict[int, str] = {}

    # ------------------------------------------------- queue introspection
    @property
    def queue(self) -> list:
        """Pending decode work items (admission order)."""
        return [w for w in self.work if isinstance(w, Request)]

    @property
    def probe_queue(self) -> list:
        """Pending probe work items (round members and stand-alones)."""
        return [w for w in self.work if isinstance(w, ProbeRequest)]

    @property
    def work_remaining(self) -> bool:
        return bool(self.work) or bool(self._rid_of_engine)

    # ----------------------------------------------------------- tenants
    def register_tenant(self, spec: TenantSpec) -> TenantSpec:
        """Install (or replace) a tenant class.  Reservations are a soft
        guarantee: their sum may exceed the row budget, in which case
        liveness wins — an empty loop always admits the highest-priority
        head regardless of debt."""
        assert spec.reserved_rows >= 0, "reserved_rows must be >= 0"
        assert spec.reserved_rows <= self.engine.max_decode_rows, (
            f"reserved_rows {spec.reserved_rows} exceeds the engine's "
            f"{self.engine.max_decode_rows} decode rows")
        self.tenants[spec.name] = spec
        self._tstats(spec.name)
        return spec

    def _spec(self, name: str) -> TenantSpec:
        return self.tenants.get(name, _DEFAULT_TENANT)

    def _tstats(self, name: str) -> TenantStats:
        ts = self.tenant_stats.get(name)
        if ts is None:
            ts = self.tenant_stats[name] = TenantStats()
        return ts

    def _check_budget(self, tenant: str, cost: int) -> None:
        """Serving-token admission control: reject a submission whose
        known-upfront cost (probe rows; 0 for open-ended decode work) would
        cross the tenant's ``token_budget`` given what it has already been
        served.  Ledger-token budgets are the executor's business."""
        spec = self._spec(tenant)
        if spec.token_budget is None:
            return
        served = self._tstats(tenant).tokens_served
        # open-ended decode work (cost 0) still needs at least one token
        # of headroom: an exhausted tenant admits nothing
        if served + max(cost, 1) > spec.token_budget:
            raise TenantBudgetExceeded(
                f"tenant {tenant!r}: {served} tokens served + {cost} "
                f"requested > budget {spec.token_budget}")

    # ------------------------------------------------------------ submit
    def submit(self, prompt, max_new: Optional[int] = 32,
               tenant: str = "default") -> int:
        """Enqueue decode work.  ``max_new`` is this REQUEST's budget: 0 is
        a genuine zero budget (PR-3 contract), ``None`` means the engine
        default."""
        self._check_budget(tenant, 0)
        r = Request(next(_ids), prompt, max_new, tenant=tenant)
        self.work.append(r)
        self._tstats(tenant).submitted += 1
        return r.rid

    def submit_probe(self, prompt, tenant: str = "default") -> int:
        self._check_budget(tenant, 1)
        r = ProbeRequest(next(_ids), prompt, tenant=tenant)
        self.work.append(r)
        return r.rid

    def submit_probe_round(self, prompts,
                           tenant: str = "default") -> RoundFuture:
        """Enqueue one oracle round's probes as a unit; returns the
        :class:`RoundFuture` that resolves — logits aligned with
        ``prompts`` — when the loop services the round in a step gap."""
        self._check_budget(tenant, len(prompts))
        fut = RoundFuture(len(prompts))
        for i, p in enumerate(prompts):
            self.work.append(ProbeRequest(next(_ids), p, future=fut, slot=i,
                                          tenant=tenant))
        return fut

    def submit_cascade_round(self, prompts, escalate: Callable,
                             tenant: str = "default") -> CascadeFuture:
        """Enqueue one cascade round: every prompt enters the DRAFT lane;
        after wave 1 resolves, ``escalate(draft_logits: {slot: logits})``
        returns the slots to re-run on the large engine — both waves are
        serviced in the SAME step gap, so fairness bounds match a plain
        round.  Admission control charges the draft wave upfront;
        escalated rows bill ``tokens_served`` as they are served (their
        count is not knowable at submit time).  Escalations also bypass
        per-tenant probe quotas: they belong to a unit the gap already
        admitted."""
        assert self.draft_engine is not None, (
            "cascade rounds need a draft engine lane "
            "(BatchScheduler(engine, draft_engine=...))")
        self._check_budget(tenant, len(prompts))
        fut = CascadeFuture(len(prompts), escalate)
        for i, p in enumerate(prompts):
            self.work.append(ProbeRequest(next(_ids), p, future=fut, slot=i,
                                          tenant=tenant, tier="draft"))
        return fut

    def submit_prefix_fill(self, prompts) -> int:
        """Enqueue a prefix-KV warm-up for structured ``(prefix, suffix)``
        prompts; the fill submission runs in the next step gap."""
        f = PrefixFill(next(_ids), [p for p in prompts
                                    if not isinstance(p, str)])
        self.work.append(f)
        return f.rid

    # ------------------------------------------------------ the step loop
    @trace.spanned("scheduler.step")
    def step(self) -> dict[int, str]:
        """ONE unified scheduling step (paged engines only):

          1. admit queued decode work into free pool/row capacity —
             priority-weighted across tenants (FIFO within each, per-class
             reservations honored), preempting strictly-lower-priority
             rows when a higher class cannot fit;
          2. service pending prefix fills, then pending probe work within
             per-tenant quotas (merged submissions, cross-submitter dedup,
             futures resolve; unregistered config services everything);
          3. one paged decode step — active rows advance one token, rows
             that finish retire and free their blocks.

        Returns {rid: output} for decode work finished this step (also
        recorded in ``completed`` and claimable via ``_fresh``)."""
        assert self.paged, "step() requires a paged-capable engine"
        eng = self.engine
        self.steps += 1
        # -- 1. decode admission (probe and fill items never block it —
        # they hold no persistent capacity)
        decode_items = []
        rest: list = []
        for w in self.work:
            (decode_items if isinstance(w, Request) else rest).append(w)
        try:
            if decode_items:
                self._admit_decode(decode_items)
        finally:
            # reassign even when admission raises mid-wave: admitted items
            # were removed from decode_items in place (and failed
            # resumes/preemptions reinserted), so the queue never holds a
            # request that already owns an engine row
            self.work = rest + decode_items   # unadmitted decode items wait

        # -- 2. fills then probes ride the step gap
        self._service_fills()
        self._service_probes()

        # serving-token billing: one token per ACTIVE owned row per decode
        # step (suspended rows are parked, not billed — a preemption cycle
        # bills exactly what a never-preempted run would)
        for erid, req in self._rid_of_engine.items():
            if erid in eng._paged_rows:
                self._tstats(req.tenant).tokens_served += 1

        # -- 3. one decode step (a no-op when no rows are active, so a
        # probe storm burns probe submissions, never decode progress)
        finished: dict[int, str] = {}
        for erid, text in eng.paged_step().items():
            req = self._rid_of_engine.pop(erid, None)
            if req is None:               # a concurrent driver's row — e.g.
                eng._paged_finished[erid] = text   # a nested generate
                continue
            req.output = text
            self.completed[req.rid] = req
            self._fresh[req.rid] = text
            finished[req.rid] = text
            self._tstats(req.tenant).finished += 1
        return finished

    # ------------------------------------------------- weighted admission
    def _need(self, w: Request) -> int:
        if w.suspended is not None:
            return w.suspended.n_blocks
        if w.block_need is None:          # tokenize once per request
            w.block_need = self.engine.paged_block_need(w.prompt, w.max_new)
        return w.block_need

    def _owned_rows_by_tenant(self) -> dict[str, int]:
        eng = self.engine
        out: dict[str, int] = {}
        for erid, req in self._rid_of_engine.items():
            if erid in eng._paged_rows:
                out[req.tenant] = out.get(req.tenant, 0) + 1
        return out

    def _admit_decode(self, items: list) -> int:
        """Admit what fits (weighted pass), preempt for the head of the
        highest waiting class if that frees enough, then admit again.
        Mirrors ``ServeEngine._paged_admit_wave``'s stuck handling: an
        empty loop that still cannot admit evicts cold prefix runs, then
        drops reservations (liveness), then raises ``PoolExhausted``."""
        eng = self.engine
        n = self._admission_pass(items)
        if items and self._preempt_for_head(items):
            n += self._admission_pass(items)
        if n == 0 and items and not eng._paged_rows:
            # stuck iff nothing IN FLIGHT can still free blocks (finished
            # rows freed theirs at retirement) — same contract as
            # _paged_admit_wave, extended with a reservation-debt fallback
            if eng._prefix_lru:           # cold prefix runs yield to decode
                eng.clear_prefix_cache()
                n = self._admission_pass(items)
            if n == 0 and items:
                n = self._admission_pass(items, ignore_reservations=True)
            if n == 0 and items:
                raise PoolExhausted(
                    f"request needs {self._need(items[0])} blocks but an "
                    f"empty pool frees only {eng.pool.free_blocks}")
        for w in items:                   # starvation accounting on waiters
            w.wait_steps += 1
            if (w.wait_steps == self.starvation_bound + 1
                    and self._spec(w.tenant).priority > 0):
                eng.stats.starved_admissions += 1
        return n

    def _admission_pass(self, items: list,
                        ignore_reservations: bool = False) -> int:
        """One weighted admission wave over the pending decode items:
        priority order (stable — FIFO by arrival within a class), each
        tenant's own queue strictly FIFO (its first non-fitting item blocks
        the rest), and a blocked class blocks every STRICTLY LOWER class
        too (head-of-line protection: freed capacity must not leak past a
        waiting high-priority head to bulk work).  ``reserved_rows`` of
        other tenants with queued decode work are held back as debt.
        Admits the wave (resumes under their original rid, fresh requests
        as one batched ``paged_admit``) and removes it from ``items``."""
        eng = self.engine
        order = sorted(range(len(items)),
                       key=lambda i: -self._spec(items[i].tenant).priority)
        active_of = self._owned_rows_by_tenant()
        queued = {w.tenant for w in items}
        taken_rows = taken_blocks = 0
        taken_of: dict[str, int] = {}
        blocked: set = set()
        floor: Optional[int] = None
        wave_idx: list[int] = []
        for i in order:
            if len(wave_idx) >= self.max_batch:
                break
            w = items[i]
            t = w.tenant
            pr = self._spec(t).priority
            if t in blocked:
                continue
            if floor is not None and pr < floor and (
                    ignore_reservations
                    or self._spec(t).reserved_rows
                    <= active_of.get(t, 0) + taken_of.get(t, 0)):
                # the floor keeps freed capacity from leaking past a
                # blocked high class to bulk work — but capacity withheld
                # by a tenant's OWN reservation is exactly theirs, so they
                # pass the floor until the reservation is filled
                continue
            need = self._need(w)
            debt = 0
            if not ignore_reservations:
                debt = sum(max(0, self._spec(u).reserved_rows
                               - active_of.get(u, 0) - taken_of.get(u, 0))
                           for u in queued if u != t)
            if not (eng.paged_room(need, rows_pending=taken_rows,
                                   blocks_pending=taken_blocks)
                    and eng.paged_active + taken_rows + debt
                    < eng.max_decode_rows):
                blocked.add(t)
                if floor is None:
                    floor = pr
                continue
            wave_idx.append(i)
            taken_rows += 1
            taken_blocks += need
            taken_of[t] = taken_of.get(t, 0) + 1
        if not wave_idx:
            return 0
        wave = [items[i] for i in wave_idx]
        for i in sorted(wave_idx, reverse=True):
            del items[i]
        fresh: list = []
        try:
            for w in wave:
                if w.suspended is not None:
                    erid = eng.paged_resume(w.suspended)
                    w.suspended = None    # cleared ONLY on success
                    self._rid_of_engine[erid] = w
                    self._tstats(w.tenant).resumes += 1
                else:
                    fresh.append(w)
            if fresh:
                rids = eng.paged_admit([(w.prompt, w.max_new)
                                        for w in fresh])
                for w, erid in zip(fresh, rids):
                    self._rid_of_engine[erid] = w
        except BaseException:
            # a failed resume rolled its allocation back and kept its stash;
            # return every wave member not yet owning an engine row to the
            # queue head (original order) so a later step retries cleanly
            owned = set(map(id, self._rid_of_engine.values()))
            items[0:0] = [w for w in wave if id(w) not in owned]
            raise
        for w in wave:
            ts = self._tstats(w.tenant)
            ts.admitted += 1
            ts.max_admission_wait = max(ts.max_admission_wait, w.wait_steps)
        return len(wave)

    def _preempt_for_head(self, items: list) -> bool:
        """Suspend the smallest set of strictly-lower-priority preemptible
        owned rows (lowest class first, newest row first within a class)
        that lets the highest-priority waiting item fit; no-op unless the
        whole set suffices.  Suspended requests re-enter the queue HEAD as
        resumable items, so the next admission pass brings them back the
        moment capacity allows."""
        eng = self.engine
        head = max(items, key=lambda w: self._spec(w.tenant).priority)
        pr = self._spec(head.tenant).priority
        victims = []
        for erid, req in self._rid_of_engine.items():
            if erid not in eng._paged_rows:
                continue
            vspec = self._spec(req.tenant)
            if vspec.preemptible and vspec.priority < pr:
                victims.append((vspec.priority, erid))
        if not victims:
            return False
        victims.sort(key=lambda v: (v[0], -v[1]))
        need = self._need(head)

        def fits(n_chosen: int, freed: int) -> bool:
            return (eng.paged_active - n_chosen < eng.max_decode_rows
                    and eng.pool.free_blocks + freed >= need)

        chosen: list[int] = []
        freed = 0
        for _p, erid in victims:
            if fits(len(chosen), freed):
                break
            chosen.append(erid)
            freed += eng.pool.freeable(eng._paged_rows[erid].blocks)
        if not fits(len(chosen), freed):
            return False                  # even everything is not enough
        for erid in chosen:
            s = eng.paged_suspend(erid)   # stash-first: a raise leaves the
            req = self._rid_of_engine.pop(erid)   # row active and owned
            req.suspended = s
            self._tstats(req.tenant).preemptions += 1
            items.insert(0, req)
        return bool(chosen)

    def pump(self) -> bool:
        """Advance the loop once: one unified :meth:`step` on paged
        engines; on lockstep engines there are no step gaps, so pending
        probe work is serviced directly.  Returns True while work remains."""
        if self.paged:
            self.step()
        else:
            with trace.span("scheduler.step"):
                self._service_fills()
                self.probe_results.update(self.run_probes())
        return self.work_remaining

    def resolve(self, future: RoundFuture) -> RoundFuture:
        """Pump the loop until ``future`` resolves (probes are serviced
        every step, so this takes at most one step — during which in-flight
        decode rows advance one token alongside)."""
        while not future.done:
            progressed = self.pump()
            if not future.done and not progressed:
                raise RuntimeError("round future cannot resolve: its probe "
                                   "work is no longer queued")
        return future

    # ----------------------------------------------------------- generate
    def generate(self, prompts, max_new: Optional[int] = None,
                 tenant: str = "default") -> list[str]:
        """Run generate requests THROUGH the live loop: submit them and
        pump until they finish.  Other queued work — probe rounds from
        concurrent plans, other drivers' decode rows — advances in the same
        steps, which is what lets a judge-rationale generation overlap
        ORDER BY probes at token granularity.  Outputs are claimed by this
        call only (an enclosing ``run`` drain keeps its own rows)."""
        if not self.paged:
            return self.engine.generate(prompts, max_new=max_new)
        # scalar max_new follows ServeEngine.generate's contract: 0/None
        # means "engine default" (a per-request zero budget is submit()'s
        # business), so the paged and lockstep branches agree
        rids = [self.submit(p, max_new or None, tenant=tenant)
                for p in prompts]
        pending = set(rids)
        while pending:
            self.step()
            pending -= self._fresh.keys()
        return [self._fresh.pop(r) for r in rids]

    # ---------------------------------------------------------------- run
    def run(self, on_step: Optional[Callable] = None) -> dict[int, str]:
        """Drain the queue; returns {rid: output} for THIS drain only.
        (Earlier drains remain queryable via ``self.completed``.)

        Continuous mode (paged engines): pumps the unified step loop until
        no decode work remains; ``on_step(self)`` runs after every step, so
        callers can submit NEW requests mid-drain — they are admitted into
        slots vacated by retiring rows while long rows keep decoding.
        Queued probe work is answered between steps.

        Lockstep mode: the whole backlog is sorted by prompt length BEFORE
        chunking into batches, so each padded batch contains similar-length
        prompts."""
        if self.paged:
            return self._run_continuous(on_step)
        drained: dict[int, str] = {}
        pending = [w for w in self.work if isinstance(w, Request)]
        self.work = [w for w in self.work if not isinstance(w, Request)]
        # sort by ENCODED length: tuple (prefix, suffix) prompts would all
        # sort as len == 2 and defeat the length grouping
        pending.sort(key=lambda r: len(self.engine._encode_prompt(r.prompt)))
        for i in range(0, len(pending), self.max_batch):
            batch = pending[i:i + self.max_batch]
            limits = [r.max_new if r.max_new is not None
                      else self.engine.max_new for r in batch]
            outs = self.engine.generate_lockstep(
                [r.prompt for r in batch],
                max_new=max(limits), max_new_per=limits)
            for r, o in zip(batch, outs):
                r.output = o
                self.completed[r.rid] = r
                drained[r.rid] = o
        return drained

    def _run_continuous(self, on_step: Optional[Callable]) -> dict[int, str]:
        drained: dict[int, str] = {}

        def claim() -> None:
            for rid in [r for r in self._fresh if r in self.completed]:
                drained[rid] = self._fresh.pop(rid)

        while any(isinstance(w, Request) for w in self.work) \
                or self._rid_of_engine:
            self.step()
            claim()
            if on_step is not None:
                on_step(self)
        claim()
        return drained

    # --------------------------------------------------------------- probes
    def run_probes(self) -> dict[int, np.ndarray]:
        """Service ALL pending probe work through length-bucketed padded
        submissions; returns {rid: last-position logits} for stand-alone
        probes of this drain (round members resolve into their futures).
        Quotas do not apply here — this is the lockstep pump path and the
        direct-call escape hatch; the step loop's gap servicing
        (:meth:`_service_probes`) is where per-tenant shares bind."""
        pending = [w for w in self.work if isinstance(w, ProbeRequest)]
        if not pending:
            return {}
        self.work = [w for w in self.work if not isinstance(w, ProbeRequest)]
        return self._service_probe_items(pending)

    def _service_probes(self) -> None:
        """Step-gap probe servicing under per-tenant quotas: pending work
        is grouped into *units* (one round's members, or a stand-alone
        probe), units are taken in (priority, arrival) order, and a unit
        past its tenant's ``probe_quota`` rows for this gap is deferred —
        unless it has aged ``starvation_bound`` gaps, which forces service
        (and trips ``starved_rounds`` for priority classes: an SLO class
        should never need the aging escape).  With no quota-bearing
        tenants registered this is exactly "service everything"."""
        pending = [w for w in self.work if isinstance(w, ProbeRequest)]
        if not pending:
            return
        eng = self.engine
        if not any(s.probe_quota is not None for s in self.tenants.values()):
            take = pending
        else:
            units: list[list[ProbeRequest]] = []
            by_future: dict[int, int] = {}
            for w in pending:
                if w.future is not None and id(w.future) in by_future:
                    units[by_future[id(w.future)]].append(w)
                    continue
                if w.future is not None:
                    by_future[id(w.future)] = len(units)
                units.append([w])
            units.sort(key=lambda u: (-self._spec(u[0].tenant).priority,
                                      u[0].rid))
            used: dict[str, int] = {}
            take = []
            for u in units:
                t = u[0].tenant
                spec = self._spec(t)
                wait = max(w.wait_steps for w in u)
                aged = wait >= self.starvation_bound
                if (spec.probe_quota is None or aged
                        or used.get(t, 0) + len(u) <= spec.probe_quota):
                    take.extend(u)
                    used[t] = used.get(t, 0) + len(u)
                    ts = self._tstats(t)
                    ts.max_round_wait = max(ts.max_round_wait, wait)
                    if aged and spec.priority > 0:
                        eng.stats.starved_rounds += 1
                else:
                    eng.stats.probe_rounds_deferred += 1
                    for w in u:
                        w.wait_steps += 1
        if not take:
            return
        taken = set(map(id, take))
        self.work = [w for w in self.work if id(w) not in taken]
        self.probe_results.update(self._service_probe_items(take))

    def _probe_chunk(self, eng) -> Optional[int]:
        """Probe-submission chunk size for ``eng``'s lane: the configured
        ``probe_batch`` (or the engine's memory ceiling), rounded UP to a
        multiple of the engine's data-shard count.  A merged drain on a
        sharded engine executes each chunk as per-data-shard row slices
        (engine ``_put_rows``); a chunk below the shard count would stay
        replicated — every shard recomputing all rows — so the gap
        servicer never hands the engine a deliberately misaligned chunk.
        Chunking only splits round MEMBERSHIP, never row content, so the
        alignment cannot change any row's bits (same-class rows pad
        identically in either chunk)."""
        mb = (self.probe_batch if self.probe_batch is not None
              else eng.max_probe_batch)
        shards = getattr(eng, "data_shards", 1)
        if mb is None or shards <= 1:
            return mb
        return -(-mb // shards) * shards

    @trace.spanned("scheduler.probes")
    def _service_probe_items(self, pending: list) -> dict[int, np.ndarray]:
        """Run one merged probe submission over ``pending`` (already
        removed from the queue).

        Cross-client dedup: concurrent operators draining through one
        scheduler routinely submit IDENTICAL prompts in the same drain
        (e.g. ASC and DESC queries over the same criteria — direction is
        folded client-side, so their probe streams coincide).  Each
        distinct prompt is executed once and its logits fanned out to
        every requester; the saved rows are counted in
        ``probes_deduped``.  Ledger billing is untouched — billing is a
        function of the logical prompt and happens at the oracle layer,
        so serving-side dedup follows the prefix-cache convention: fewer
        forward-pass rows, identical accounting.

        Cascade rounds run their draft wave FIRST (on the draft-engine
        lane); their escalations join this gap's large-lane submission, so
        both waves complete before the gap closes."""
        if trace.recording():
            self._count_round_waits(pending)
        draft = [w for w in pending if w.tier == "draft"]
        if draft:
            pending = [w for w in pending if w.tier != "draft"]
            try:
                pending = pending + self._run_draft_wave(draft)
            except BaseException:
                # the draft wave re-queued its own items; large-lane items
                # of this drain were never touched, so they wait alongside
                self.work[0:0] = pending
                raise
            if not pending:
                return {}
        slot_of: dict[tuple, int] = {}
        uniq: list = []
        slots: list[int] = []
        for r in pending:
            key = _probe_key(r.prompt)
            if key not in slot_of:
                slot_of[key] = len(uniq)
                uniq.append(r.prompt)
            slots.append(slot_of[key])
        try:
            logits = self.engine.submit_probes(
                uniq, max_batch=self._probe_chunk(self.engine))
        except BaseException:
            # transient engine failure: the items must stay resolvable, so
            # they return to the queue head and the next pump retries (the
            # engine's probe path is stateless per submission — a retry
            # recomputes bit-identical logits)
            self.work[0:0] = pending
            raise
        self.probes_deduped += len(pending) - len(uniq)
        rounds_seen: set = set()
        out: dict[int, np.ndarray] = {}
        for r, s in zip(pending, slots):
            ts = self._tstats(r.tenant)
            ts.probe_rows += 1
            ts.tokens_served += 1
            key = id(r.future) if r.future is not None else id(r)
            if key not in rounds_seen:
                rounds_seen.add(key)
                # cascade rounds were counted as serviced at draft time
                if not isinstance(r.future, CascadeFuture):
                    ts.rounds_serviced += 1
            r.logits = logits[s]
            if r.future is not None:
                r.future._set(r.slot, r.logits)
            else:
                out[r.rid] = r.logits
        return out

    @staticmethod
    def _count_round_waits(pending: list) -> None:
        """Each round's queue wait, from its submission to the first
        servicing of any of its members, counted once, where stamped."""
        t = time.perf_counter_ns()
        for r in pending:
            fut = r.future
            if fut is not None and fut._queued_ns is not None:
                trace.count("scheduler.round_wait_ns", t - fut._queued_ns)
                trace.count("scheduler.rounds")
                fut._queued_ns = None

    def _run_draft_wave(self, items: list) -> list:
        """Wave 1 of this gap's cascade rounds: one merged (deduped)
        submission on the draft engine, then each round's ``escalate``
        callback splits its slots — non-escalated slots resolve with their
        draft logits, escalated slots return as fresh large-lane
        :class:`ProbeRequest`\\ s (same prompt, same future) for the caller
        to service in the SAME gap.  Only the engine submission is
        retryable (re-queue + raise); a raising ``escalate`` is an
        oracle-layer bug, not a transient."""
        eng = self.draft_engine
        slot_of: dict[tuple, int] = {}
        uniq: list = []
        slots: list[int] = []
        for r in items:
            key = _probe_key(r.prompt)
            if key not in slot_of:
                slot_of[key] = len(uniq)
                uniq.append(r.prompt)
            slots.append(slot_of[key])
        try:
            logits = eng.submit_probes(uniq,
                                       max_batch=self._probe_chunk(eng))
        except BaseException:
            self.work[0:0] = items
            raise
        self.probes_deduped += len(items) - len(uniq)
        self.probes_drafted += len(items)
        groups: dict[int, list] = {}
        futs: dict[int, CascadeFuture] = {}
        for r, s in zip(items, slots):
            assert isinstance(r.future, CascadeFuture), \
                "draft-tier probes exist only inside cascade rounds"
            r.logits = logits[s]
            ts = self._tstats(r.tenant)
            ts.probe_rows += 1
            ts.tokens_served += 1
            if id(r.future) not in groups:
                ts.rounds_serviced += 1
            groups.setdefault(id(r.future), []).append(r)
            futs[id(r.future)] = r.future
        escalated: list = []
        for fid, members in groups.items():
            fut = futs[fid]
            esc = set(fut.escalate({w.slot: w.logits for w in members}))
            fut.escalated |= esc
            for w in members:
                if w.slot in esc:
                    escalated.append(ProbeRequest(next(_ids), w.prompt,
                                                  future=fut, slot=w.slot,
                                                  tenant=w.tenant))
                else:
                    fut._set(w.slot, w.logits)
        self.probes_escalated += len(escalated)
        return escalated

    @trace.spanned("scheduler.fills")
    def _service_fills(self) -> None:
        fills = [w for w in self.work if isinstance(w, PrefixFill)]
        if not fills:
            return
        self.work = [w for w in self.work if not isinstance(w, PrefixFill)]
        prompts = [p for f in fills for p in f.prompts]
        if not prompts:
            return
        try:
            n = self.engine.prefetch_prefixes(prompts)
        except BaseException:
            self.work[0:0] = fills        # transient failure: keep the work
            raise
        self.fills_serviced += len(fills)
        self.regions_prefetched += n
