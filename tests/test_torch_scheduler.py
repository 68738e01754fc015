"""The port's ``BatchScheduler`` against the reference's, on fake engines that
keep the paged machinery real.

``PortFakePagedEngine`` below is the twin of ``tests/fakes_paged.py`` built on
the port's ``ServeEngine`` and ``KVBlockPool`` (arenas written in place): only
the model is faked, admission, preemption, stash/unstash and rollback are the
production code of each package.  The same seeded op scripts as
``test_fuzz_loop.py``'s fast profile, and the scenarios behind the contracts of
``test_cosched.py`` and ``test_tenancy.py``, run through both schedulers; their
step traces, per-tenant ledgers, outputs, probe results and pool counters must
be identical, and the contracts themselves are asserted on the port.
"""
import dataclasses
import importlib
import itertools
from collections import OrderedDict
from types import SimpleNamespace

import numpy as np
import pytest

from fakes_paged import FakePagedEngine as RefFakePagedEngine
from repro_torch.serving.engine import ServeEngine, ServeStats, _PagedRow
from repro_torch.serving.kv_pool import KVBlockPool

PKGS = ("repro", "repro_torch")
STATS_FIELDS = [f.name for f in dataclasses.fields(ServeStats)]


def tiny_pool_lm():
    """The minimal cfg surface KVBlockPool reads: two tiny attn stacks."""
    return SimpleNamespace(cfg=SimpleNamespace(
        pattern=[("attn", 2)], n_kv_heads=1, hd=2, dtype="float32"))


def _prompt_hash(text: str) -> int:
    h = 0
    for c in text:
        h = (h * 31 + ord(c)) % 997
    return h


class PortFakePagedEngine(ServeEngine):
    """``tests/fakes_paged.FakePagedEngine`` on the port's types: admission
    writes a per-block fingerprint of the prompt into the pool's arena, each
    decode step reads it back to emit the next token."""

    paged_enabled = True
    prefix_cache_enabled = False

    def __init__(self, num_blocks: int = 33, block_size: int = 4,
                 max_decode_rows: int = 4, max_new: int = 6,
                 max_probe_batch: int = 256):
        # deliberately no ServeEngine.__init__ (no model)
        self.max_new = max_new
        self.max_decode_rows = max_decode_rows
        self.max_probe_batch = max_probe_batch
        self.stats = ServeStats()
        self.pool = KVBlockPool(tiny_pool_lm(), num_blocks, block_size, device="cpu")
        self._prefix_lru = OrderedDict()
        self._paged_rows = {}
        self._paged_finished = {}
        self._paged_ids = itertools.count()
        self.submitted = []
        self.prefetched = []

    def _encode_prompt(self, prompt):
        prefix, suffix = self._parts(prompt)
        text = suffix if prefix is None else prefix + suffix
        return [ord(c) % 50 + 1 for c in text]

    def _pad_class(self, length: int) -> int:
        return -(-max(length, 1) // 4) * 4

    def submit_probes(self, prompts, max_batch=None):
        self.submitted.append(list(prompts))
        out = np.zeros((len(prompts), 4), np.float32)
        for i, p in enumerate(prompts):
            key = p if isinstance(p, str) else "".join(p)
            out[i] = _prompt_hash(key) + np.arange(4)
        return out

    def prefetch_prefixes(self, prompts):
        self.prefetched.append(list(prompts))
        return len(prompts)

    def _fingerprint(self, blocks) -> int:
        slab = self.pool.arenas[0].k[0, :, 0, 0, 0].tolist()
        return int(round(float(sum(slab[b] for b in blocks))))

    def paged_admit(self, requests):
        counts, needs = [], []
        for prompt, max_new in requests:
            cls = self._pad_class(len(self._encode_prompt(prompt)))
            needs.append(cls)
            counts.append(self.pool.blocks_for(cls + self._row_limit(max_new)))
        runs = self._alloc_rows(counts)
        rids = []
        k = self.pool.arenas[0].k
        for (prompt, max_new), cls, run in zip(requests, needs, runs):
            rid = next(self._paged_ids)
            prefix, suffix = self._parts(prompt)
            h = _prompt_hash(suffix if prefix is None else prefix + suffix)
            for j, b in enumerate(run):
                k[0, b, 0, 0, 0] = float((h + 7 * j) % 101)
            self._paged_rows[rid] = _PagedRow(
                rid=rid, cls=cls, limit=self._row_limit(max_new),
                blocks=run, n_shared=0, cur=0, t=0, emitted=[])
            rids.append(rid)
        self.stats.calls += 1
        return rids

    def paged_step(self):
        done: dict[int, str] = {}
        for rid, row in list(self._paged_rows.items()):
            tok = (self._fingerprint(row.blocks) + 1 + 3 * row.t) % 23
            row.emitted.append(tok)
            row.t += 1
            self.stats.decode_tokens += 1
            if tok == 0 or row.t >= row.limit:
                del self._paged_rows[rid]
                self.pool.decref(row.blocks)
                done[rid] = " ".join(str(t) for t in row.emitted)
        finished, self._paged_finished = self._paged_finished, {}
        finished.update(done)
        return finished


FAKES = {"repro": RefFakePagedEngine, "repro_torch": PortFakePagedEngine}


def serving(pkg):
    return importlib.import_module(f"{pkg}.serving")


class Run:
    """One package's scheduler over its fake engine, recording a step trace:
    after every step the step count, live engine rows, pool occupancy, free
    list and engine counters."""

    def __init__(self, pkg, engine_kw, **sched_kw):
        self.pkg = pkg
        self.s = serving(pkg)
        self.eng = FAKES[pkg](**engine_kw)
        self.sched = self.s.BatchScheduler(self.eng, **sched_kw)
        self.trace = []
        # request ids come from a counter shared by the module's schedulers:
        # the state holds them relative to the next id at the run's start
        self.base = next(importlib.import_module(f"{pkg}.serving.scheduler")._ids)

    def tenant(self, name, **kw):
        self.sched.register_tenant(self.s.TenantSpec(name, **kw))

    def step(self):
        self.sched.step()
        self.record()

    def run(self):
        out = self.sched.run(on_step=lambda _s: self.record())
        self.record()
        return out

    def record(self):
        eng = self.eng
        self.trace.append((self.sched.steps, sorted(eng._paged_rows), eng.pool.blocks_in_use,
                           list(eng.pool._free), stats(eng)))

    def state(self) -> str:
        """Everything the two packages must agree on, as one string."""
        pool = self.eng.pool
        return repr((
            self.trace, stats(self.eng),
            {rid - self.base: req.output for rid, req in sorted(self.sched.completed.items())},
            {rid - self.base: np.asarray(v).tolist()
             for rid, v in sorted(self.sched.probe_results.items())},
            {name: repr(ts) for name, ts in sorted(self.sched.tenant_stats.items())},
            (pool.blocks_in_use, pool.peak_in_use, pool.total_allocs, pool.total_leased,
             pool.lease_shortfalls, pool.total_stashed, pool.total_unstashed),
            self.eng.submitted, self.eng.prefetched, self.sched.probes_deduped))


def stats(eng) -> tuple:
    return tuple(getattr(eng.stats, f) for f in STATS_FIELDS)


def identical(scenario, *args):
    """Run ``scenario(pkg, *args)`` under both packages; their states must
    be equal.  Returns the port's run."""
    ref, port = (scenario(pkg, *args) for pkg in PKGS)
    assert port.state() == ref.state()
    return port


def solo_out(prompt, budget, **eng_kw):
    r = Run("repro_torch", eng_kw)
    rid = r.sched.submit(prompt, budget)
    return r.run()[rid]


# ------------------------------------------------ test_fuzz_loop, fast profile
ENGINE_KW = dict(num_blocks=25, max_decode_rows=3, max_new=8)
TENANTS = [dict(name="bulk", priority=0, probe_quota=6),
           dict(name="live", priority=10, reserved_rows=1),
           dict(name="mid", priority=3)]
NAMES = ["default", "bulk", "live", "mid"]


def fuzz(pkg, seed, n_ops, fail_rate=0.0):
    """``test_fuzz_loop._fuzz``'s op script, recording instead of asserting."""
    rng = np.random.default_rng(seed)
    r = Run(pkg, ENGINE_KW, starvation_bound=4)
    for t in TENANTS:
        r.tenant(t["name"], **{k: v for k, v in t.items() if k != "name"})
    sched, eng = r.sched, r.eng
    r.decode, r.rounds, r.singles = [], [], []
    if fail_rate:
        real_probes, real_fills = eng.submit_probes, eng.prefetch_prefixes

        def flaky_probes(prompts, max_batch=None):
            if rng.random() < fail_rate:
                raise RuntimeError("transient probe failure")
            return real_probes(prompts, max_batch=max_batch)

        def flaky_fills(prompts):
            if rng.random() < fail_rate:
                raise RuntimeError("transient fill failure")
            return real_fills(prompts)

        eng.submit_probes, eng.prefetch_prefixes = flaky_probes, flaky_fills

    def step():
        try:
            r.step()
        except RuntimeError as e:          # injected transient failures only
            assert "transient" in str(e)
            r.trace.append(("failed", str(e)))

    for i in range(n_ops):
        op = rng.random()
        tenant = NAMES[int(rng.integers(len(NAMES)))]
        if op < 0.35:
            prompt = f"gen {tenant} {seed} {i} " + "x" * int(rng.integers(12))
            budget = int(rng.integers(1, 9))
            r.decode.append((tenant, prompt, budget, sched.submit(prompt, budget, tenant=tenant)))
        elif op < 0.55:
            prompts = [f"probe {seed} {i} {j}" for j in range(int(rng.integers(1, 7)))]
            r.rounds.append((sched.submit_probe_round(prompts, tenant=tenant), prompts, tenant))
        elif op < 0.65:
            prompt = f"single {seed} {i}"
            r.singles.append((sched.submit_probe(prompt, tenant=tenant), prompt, tenant))
        elif op < 0.72:
            sched.submit_prefix_fill([(f"pre {i}", f"suf {i}")])
        else:
            step()
    guard = 0
    while sched.work_remaining:
        step()
        guard += 1
        assert guard < 10_000, "drain did not terminate"
    r.trace.append(("rounds", [np.asarray(f.result()).tolist() for f, _p, _t in r.rounds]))
    return r


def fuzz_contracts(r, seed):
    """``test_fuzz_loop``'s invariants, on the port."""
    eng, sched = r.eng, r.sched
    assert eng.pool.blocks_in_use == 0, "leaked KV blocks"
    assert eng.stats.preempt_resumes == eng.stats.preempt_suspends
    assert eng.pool.total_unstashed == eng.pool.total_stashed
    assert all(f.done for f, _p, _t in r.rounds)
    assert all(rid in sched.probe_results for rid, _p, _t in r.singles)
    expect: dict = {}
    for tenant, prompt, budget, rid in r.decode:
        solo = solo_out(prompt, budget, **ENGINE_KW)
        assert sched.completed[rid].output == solo, (seed, prompt)
        expect[tenant] = expect.get(tenant, 0) + len(solo.split())
    clean = PortFakePagedEngine(**ENGINE_KW)
    for fut, prompts, tenant in r.rounds:
        expect[tenant] = expect.get(tenant, 0) + len(prompts)
        for got, want in zip(fut.result(), clean.submit_probes(prompts)):
            assert np.array_equal(got, want)
    for rid, prompt, tenant in r.singles:
        expect[tenant] = expect.get(tenant, 0) + 1
        assert np.array_equal(sched.probe_results[rid], clean.submit_probes([prompt])[0])
    for tenant, n in expect.items():
        assert sched.tenant_stats[tenant].tokens_served == n, (seed, tenant)


@pytest.mark.parametrize("seed", range(6))
def test_fuzz_interleavings_identical(seed):
    fuzz_contracts(identical(fuzz, seed, 60), seed)


@pytest.mark.parametrize("seed", range(4))
def test_fuzz_with_transient_failures_identical(seed):
    fuzz_contracts(identical(fuzz, 100 + seed, 50, 0.25), 100 + seed)


def preemption_pressure(pkg):
    rng = np.random.default_rng(7)
    r = Run(pkg, dict(num_blocks=11, max_decode_rows=3, max_new=12), starvation_bound=4)
    r.tenant("bulk", priority=0)
    r.tenant("live", priority=10)
    r.decode = []
    for i in range(12):
        prompt = f"bulk {i} " + "y" * int(rng.integers(6))
        r.decode.append((prompt, r.sched.submit(prompt, 12, tenant="bulk")))
        if i % 3 == 2:
            r.step()
            prompt = f"live burst {i} extra"
            r.decode.append((prompt, r.sched.submit(prompt, 12, tenant="live")))
    r.outs = r.run()
    return r


def test_fuzz_under_preemption_pressure_identical():
    r = identical(preemption_pressure)
    assert r.eng.stats.preempt_suspends >= 1
    assert r.eng.stats.preempt_resumes == r.eng.stats.preempt_suspends
    assert r.eng.pool.blocks_in_use == 0
    for prompt, rid in r.decode:
        assert r.outs[rid] == solo_out(prompt, 12, num_blocks=11, max_decode_rows=3,
                                       max_new=12)


# ------------------------------------------------------- test_tenancy
TENANCY_KW = dict(num_blocks=11, max_decode_rows=3, max_new=12)


def preemption(pkg, preemptible=True):
    r = Run(pkg, TENANCY_KW)
    r.tenant("bulk", priority=0, preemptible=preemptible)
    r.tenant("live", priority=10)
    r.rids = [r.sched.submit("bulk one", 12, tenant="bulk"),
              r.sched.submit("bulk twoooo", 12, tenant="bulk")]
    r.step()
    r.rids.append(r.sched.submit("live priority", 12, tenant="live"))
    r.outs = r.run()
    return r


def test_preemption_identity_and_billing_identical():
    r = identical(preemption)
    st, ts, outs = r.eng.stats, r.sched.tenant_stats, r.outs
    assert st.preempt_suspends >= 1 and st.preempt_resumes == st.preempt_suspends
    assert r.eng.pool.total_unstashed == r.eng.pool.total_stashed > 0
    assert ts["bulk"].preemptions >= 1 and ts["bulk"].resumes >= 1
    for prompt, rid in zip(("bulk one", "bulk twoooo", "live priority"), r.rids):
        assert outs[rid] == solo_out(prompt, 12, **TENANCY_KW)
    b1, b2, l1 = r.rids
    assert ts["bulk"].tokens_served == len(outs[b1].split()) + len(outs[b2].split())
    assert ts["live"].tokens_served == len(outs[l1].split())
    assert r.eng.pool.blocks_in_use == 0


def test_non_preemptible_class_identical():
    r = identical(preemption, False)
    assert r.eng.stats.preempt_suspends == 0
    assert r.sched.tenant_stats["bulk"].preemptions == 0
    assert r.eng.pool.blocks_in_use == 0


def reservations(pkg):
    r = Run(pkg, dict(num_blocks=33, max_decode_rows=2, max_new=4))
    r.tenant("fast", priority=5)
    r.tenant("resv", priority=0, reserved_rows=1)
    r.rids = [r.sched.submit("fast one", 4, tenant="fast"),
              r.sched.submit("fast two", 4, tenant="fast"),
              r.sched.submit("reserved", 4, tenant="resv")]
    r.step()
    r.owners = {req.tenant for erid, req in r.sched._rid_of_engine.items()
                if erid in r.eng._paged_rows}
    r.outs = r.run()
    return r


def test_reserved_rows_identical():
    r = identical(reservations)
    assert r.owners == {"fast", "resv"}
    assert set(r.outs) == set(r.rids) and r.eng.pool.blocks_in_use == 0


def liveness(pkg):
    r = Run(pkg, dict(num_blocks=33, max_decode_rows=2, max_new=4))
    r.tenant("a", reserved_rows=2)
    r.tenant("b", reserved_rows=2)
    r.rids = [r.sched.submit("a job", 4, tenant="a"), r.sched.submit("b job", 4, tenant="b")]
    r.outs = r.run()
    return r


def test_liveness_beats_reservations_identical():
    r = identical(liveness)
    assert set(r.outs) == set(r.rids) and r.eng.pool.blocks_in_use == 0


def token_budget(pkg):
    r = Run(pkg, {})
    r.tenant("metered", token_budget=3)
    r.fut = r.sched.submit_probe_round(["p1", "p2", "p3"], tenant="metered")
    r.step()
    r.rejected = []
    for submit in (lambda: r.sched.submit_probe("p4", tenant="metered"),
                   lambda: r.sched.submit("gen", 4, tenant="metered")):
        try:
            submit()
        except r.s.TenantBudgetExceeded as e:
            r.rejected.append(str(e))
    r.other = r.sched.submit_probe("p4", tenant="default")
    r.trace.append((r.rejected, r.other - r.base))
    return r


def test_token_budget_rejects_identical():
    r = identical(token_budget)
    assert r.fut.done and r.sched.tenant_stats["metered"].tokens_served == 3
    assert len(r.rejected) == 2 and r.other >= 0


def probe_quota(pkg):
    r = Run(pkg, {}, starvation_bound=3)
    r.tenant("bulk", probe_quota=2)
    r.big = r.sched.submit_probe_round([f"b{i}" for i in range(4)], tenant="bulk")
    r.small = r.sched.submit_probe_round(["s0"], tenant="bulk")
    r.step()
    r.first = (r.small.done, r.big.done, r.eng.stats.probe_rounds_deferred)
    for _ in range(3):
        r.step()
    r.trace.append(np.asarray(r.big.result()).tolist())
    return r


def test_probe_quota_defers_then_ages_identical():
    r = identical(probe_quota)
    assert r.first == (True, False, 1)
    assert r.big.done and r.eng.stats.starved_rounds == 0
    assert r.sched.tenant_stats["bulk"].max_round_wait >= 3
    direct = PortFakePagedEngine().submit_probes([f"b{i}" for i in range(4)])
    for got, want in zip(r.big.result(), direct):
        assert np.array_equal(got, want)


def saturating_bulk(pkg):
    r = Run(pkg, dict(num_blocks=21, max_decode_rows=3, max_new=10), starvation_bound=4)
    r.tenant("bulk", priority=0, probe_quota=4)
    r.tenant("live", priority=5, reserved_rows=1)
    for i in range(6):
        r.sched.submit(f"bulk job number {i}", 10, tenant="bulk")
    r.live_done = []
    for step in range(30):
        r.sched.submit_probe_round([f"bulk probe {step} {j}" for j in range(8)], tenant="bulk")
        fut = r.sched.submit_probe_round([f"live probe {step}"], tenant="live")
        if step == 5:
            r.live_decode = r.sched.submit("live decode", 3, tenant="live")
        r.step()
        r.live_done.append(fut.done)
    r.run()
    return r


def test_interactive_tenant_not_starved_identical():
    r = identical(saturating_bulk)
    assert all(r.live_done)
    assert r.sched.tenant_stats["live"].max_admission_wait <= r.sched.starvation_bound
    assert r.eng.stats.starved_rounds == 0 and r.eng.stats.starved_admissions == 0
    assert r.eng.stats.probe_rounds_deferred > 0
    assert r.sched.completed[r.live_decode].output == solo_out(
        "live decode", 3, num_blocks=21, max_decode_rows=3, max_new=10)
    assert r.eng.pool.blocks_in_use == 0


def test_ledger_budget_cancels_executor_plans_identical():
    """The executor cancels a tenant's plans once its ledger slices cross the
    tenant's ledger budget; other tenants keep running."""
    def run(pkg):
        c = importlib.import_module(f"{pkg}.core")
        from_exec = importlib.import_module(f"{pkg}.core.executor")
        keys = c.as_keys([f"item {i}" for i in range(12)], list(np.linspace(0.0, 1.0, 12)))
        spec = c.SortSpec("c", False, None)
        ex = c.ProbePlanExecutor(tenant_budgets={"bulk": 10})
        capped = ex.submit_path(c.make_path("quick", c.PathParams(batch_size=4)), keys,
                                c.SimulatedOracle(c.REASONING), spec, tenant="bulk")
        free = ex.submit_path(c.make_path("quick", c.PathParams(batch_size=4)), keys,
                              c.SimulatedOracle(c.REASONING), spec, tenant="live")
        ex.run()
        assert isinstance(capped.error, from_exec.PlanCancelled)
        assert "ledger budget" in str(capped.error) and ex.budget_cancelled == 1
        assert free.error is None
        return repr((str(capped.error), free.result, ex.budget_cancelled))
    ref, port = (run(pkg) for pkg in PKGS)
    assert ref == port


# --------------------------------------------------------- test_cosched
class LockstepFake:
    """Deterministic per-prompt logits; records submissions.  Not paged:
    the scheduler's lockstep pump path."""

    paged_enabled = False
    max_probe_batch = 256

    def __init__(self):
        self.submitted, self.prefetched = [], []

    def prefetch_prefixes(self, prompts):
        self.prefetched.append(list(prompts))
        return len(prompts)

    def submit_probes(self, prompts, max_batch=None):
        self.submitted.append(list(prompts))
        out = np.zeros((len(prompts), 4), np.float32)
        for i, p in enumerate(prompts):
            out[i] = _prompt_hash(p if isinstance(p, str) else "".join(p)) + np.arange(4)
        return out


def lockstep_loop(pkg):
    """Typed work items, dedup across singles and rounds, fills serviced by
    the lockstep pump, round order kept under dedup."""
    s = importlib.import_module(f"{pkg}.serving.scheduler")
    eng = LockstepFake()
    sched = s.BatchScheduler(eng)
    sched.submit("gen", max_new=2)
    rid = sched.submit_probe("alpha")
    f1 = sched.submit_probe_round(["alpha", "beta"])
    f2 = sched.submit_probe_round(["beta", "alpha", "beta"])
    sched.submit_prefix_fill([("p", "s"), "plain ignored"])
    kinds = [type(w).__name__ for w in sched.work]
    out = sched.run_probes()
    sched.pump()
    return SimpleNamespace(state=repr((
        kinds, np.asarray(out[rid]).tolist(), np.asarray(f1.result()).tolist(),
        np.asarray(f2.result()).tolist(), eng.submitted, eng.prefetched,
        sched.probes_deduped, sched.work_remaining)), f1=f1, f2=f2, out=out[rid],
        eng=eng, sched=sched, kinds=kinds)


def test_lockstep_loop_mechanics_identical():
    ref, port = lockstep_loop("repro"), lockstep_loop("repro_torch")
    assert port.state == ref.state
    assert port.kinds == ["Request", "ProbeRequest", "ProbeRequest", "ProbeRequest",
                          "ProbeRequest", "ProbeRequest", "ProbeRequest", "PrefixFill"]
    assert port.eng.submitted == [["alpha", "beta"]]
    assert port.sched.probes_deduped == 4
    assert np.array_equal(port.out, port.f1.result()[0])
    assert np.array_equal(port.f1.result()[1], port.f2.result()[0])
    assert np.array_equal(port.f2.result()[0], port.f2.result()[2])
    assert port.eng.prefetched == [[("p", "s")]]


def probe_rounds_during_decode(pkg):
    """A round submitted mid-decode resolves in the next step gap, and
    decode rows advance one token a step under a probe storm."""
    r = Run(pkg, dict(num_blocks=33, max_decode_rows=4, max_new=12))
    r.rid = r.sched.submit("w" * 30 + " long rationale", 12)
    r.seen = {}
    r.storm = []

    def on_step(s):
        r.record()
        if r.eng.paged_active:
            r.storm.extend(s.submit_probe_round([f"storm {i} {len(r.storm)}"])
                           for i in range(3))
        if "fut" not in r.seen and r.eng.paged_active:
            r.seen["fut"], r.seen["at"] = s.submit_probe_round(["Item: thing"]), s.steps
        elif "fut" in r.seen and "done_at" not in r.seen and r.seen["fut"].done:
            r.seen["done_at"] = s.steps

    r.outs = r.sched.run(on_step=on_step)
    r.trace.append([np.asarray(f.result()).tolist() for f in r.storm])
    return r


def test_probe_rounds_during_decode_identical():
    r = identical(probe_rounds_during_decode)
    assert r.seen["done_at"] - r.seen["at"] <= 1
    assert all(f.done for f in r.storm)
    assert r.outs[r.rid] == solo_out("w" * 30 + " long rationale", 12, num_blocks=33,
                                     max_decode_rows=4, max_new=12)
    assert r.eng.pool.blocks_in_use == 0
