"""The closed loop that drives the program, and the benchmark's own spans and
captures around the program's public calls.

One ``ProbePlanExecutor`` over one ``BatchScheduler`` over one
``ServeEngine``: every query gets its own ``ModelOracle``; a static path is
submitted with ``submit_path``, an ``auto`` query runs as an
``OptimizerDriver`` on the same executor, advanced by ``on_tick``.  Each of
the mix's clients submits its next query the moment its last one returns.

Spans are timed here, around the calls into each layer (operator tick and
driver tick, scheduler round submission and pump, engine probe
submission); with ``annotate`` each span is also a ``torch.profiler``
range, so that a device trace can name what the host was doing in each
idle gap.  The capture keeps what the check and the FLOP count need: each
query's probe rounds (payload, the six read-out logits of each row, the raw
answers the oracle returned).

What it pins of the program beyond its public calls: the round token that
``ModelOracle.begin_probe_round`` returns is read as ``token[1]``, the
scheduler's handle, whose ``result()`` is the round's served logits.
"""
from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass, field
from typing import Optional

import numpy as np

from .reference import READOUT_COLUMNS
from .traffic import make_table


class Spans:
    """Host spans by name.  While ``on``, ``operator_self`` accrues the time
    of ``operator.*`` spans less the time of the spans directly inside them
    (the serving calls they wait on)."""

    def __init__(self, annotate: bool):
        self.annotate = annotate
        self.on = False
        self.stack: list = []
        self.operator_self = 0.0

    @contextlib.contextmanager
    def span(self, name: str):
        entry = [name, 0.0]
        self.stack.append(entry)
        if self.annotate:
            from torch.profiler import record_function
            ctx = record_function(name)
        else:
            ctx = contextlib.nullcontext()
        t0 = time.perf_counter()
        try:
            with ctx:
                yield
        finally:
            dt = time.perf_counter() - t0
            self.stack.pop()
            if self.stack:
                self.stack[-1][1] += dt
            if self.on and name.startswith("operator."):
                self.operator_self += dt - entry[1]

    def inside(self, prefix: str) -> bool:
        return any(name.startswith(prefix) for name, _ in self.stack)

    def wrap(self, obj, attr: str, name: str):
        """Replace ``obj.attr`` (on the instance) by a spanned call."""
        fn = getattr(obj, attr)

        def spanned(*args, **kwargs):
            with self.span(name):
                return fn(*args, **kwargs)

        setattr(obj, attr, spanned)


@dataclass
class Round:
    kind: str
    payload: list          # [(uid, text)] or, for compare, [((uid, text), (uid, text))]
    criteria: str
    six: np.ndarray        # (rows, 6) read-out logits as served
    raw: list              # the oracle's raw answers
    in_window: bool        # answered inside the measured window


@dataclass
class Query:
    client: int
    index: int
    t_submit: float
    keys: list
    spec: object
    oracle: object
    run: object = None
    driver: object = None
    in_window: bool = False
    t_done: Optional[float] = None
    result: object = None
    error: Optional[BaseException] = None
    rounds: list = field(default_factory=list)
    n_calls: int = 0


class ClosedLoop:
    def __init__(self, program, engine, sched, mix: dict, seed: int,
                 spans: Spans):
        self.p = program                      # the program's modules
        self.engine = engine
        self.sched = sched
        self.mix = mix
        self.seed = seed
        self.spans = spans
        self.ex = program.executor.ProbePlanExecutor(scheduler=sched)
        self.live: list[Query] = []
        self.returned: list[Query] = []       # queries returned since the window opened
        self.next_index = [0] * mix["clients"]
        self.accepting = True
        self.window = False
        self.billed_done = 0
        self.ticks = 0
        self.step_s = 0.0                     # the last step's seconds
        self.tracking = False
        s = spans
        s.wrap(engine, "submit_probes", "engine.submit_probes")
        s.wrap(sched, "submit_probe_round", "scheduler.submit_probe_round")
        s.wrap(sched, "pump", "scheduler.pump")

    def _watch(self, q: Query) -> None:
        """Record each of the query's probe rounds as the oracle answers it."""
        oracle = q.oracle
        begin, finish = oracle.begin_probe_round, oracle.finish_probe_round
        pending: dict = {}

        def begun(kind, payload, criteria, sink):
            token = begin(kind, payload, criteria, sink)
            pending[id(token)] = (kind, payload, criteria)
            return token

        def finished(token, sink):
            raw = finish(token, sink)
            kind, payload, criteria = pending.pop(id(token))
            logits = token[1].result()
            six = np.stack([np.asarray(l)[list(READOUT_COLUMNS)]
                            for l in logits]) if logits else np.zeros((0, 6))
            if kind == "compare":
                items = [((a.uid, a.text), (b.uid, b.text)) for a, b in payload]
            elif kind in ("score_batches", "rank_windows"):
                items = [[(k.uid, k.text) for k in b] for b in payload]
            else:
                items = [(k.uid, k.text) for k in payload]
            q.rounds.append(Round(kind, items, criteria, six, raw, self.window))
            return raw

        oracle.begin_probe_round = begun
        oracle.finish_probe_round = finished

    # ----------------------------------------------------------------- queries
    def _submit(self, client: int) -> None:
        p, mix = self.p, self.mix
        idx = self.next_index[client]
        self.next_index[client] += 1
        table = make_table(mix, self.seed, client, idx)
        keys = [p.types.Key(uid=u, text=t, latent=z) for u, t, z in table.rows]
        spec = p.types.SortSpec(table.criteria, mix["descending"], mix["limit"])
        oracle = p.model_oracle.ModelOracle(self.engine)
        q = Query(client, idx, time.perf_counter(), keys, spec, oracle,
                  in_window=self.window)
        self._watch(q)
        name = f"c{client}q{idx}"
        if mix["path"] == "auto":
            opt = p.optimizer.AccessPathOptimizer(p.optimizer.OptimizerConfig(
                sample_size=mix.get("sample_size", 20), budget=mix.get("budget"),
                strategy=mix.get("strategy", "borda"), **mix.get("optimizer", {})))
            q.driver = p.optimizer.OptimizerDriver(opt, keys, oracle, spec,
                                                   executor=self.ex, name=name)
        else:
            path = p.access_paths.make_path(
                mix["path"], p.access_paths.PathParams(**mix.get("params", {})))
            q.run = self.ex.submit_path(path, keys, oracle, spec, name=name)
        self.live.append(q)

    def start(self) -> None:
        for c in range(self.mix["clients"]):
            self._submit(c)

    def billed(self) -> int:
        """Logical probe calls billed so far to every query (each query's
        ledger: a prompt deduplicated across queries counts for each)."""
        return self.billed_done + sum(len(q.oracle.ledger.records)
                                      for q in self.live)

    def step(self) -> None:
        """One tick of the executor, then each live driver's tick, then the
        harvest of finished queries (whose clients submit again)."""
        t = time.perf_counter()
        with self.spans.span("operator.tick"):
            self.ex.tick()
        for q in list(self.live):
            if q.driver is not None and q.error is None:
                with self.spans.span("operator.on_tick"):
                    try:
                        q.driver.on_tick(self.ex)
                    except Exception as e:   # the query's plan raised
                        q.error = e
        if self.window:
            self.ticks += 1
        self._harvest()
        self.step_s = time.perf_counter() - t

    def _harvest(self) -> None:
        p = self.p
        still = []
        for q in self.live:
            if q.driver is not None:
                done = q.driver.done or q.error is not None
            else:
                done = q.run.done
            if not done:
                still.append(q)
                continue
            q.t_done = time.perf_counter()
            if q.driver is not None:
                q.result = q.driver.result
            elif q.run.error is not None:
                q.error = q.run.error
            else:
                q.result = p.executor.plan_sort_result(
                    q.run, q.spec, len(q.keys), q.oracle.prices)
            q.n_calls = len(q.oracle.ledger.records)
            self.billed_done += q.n_calls
            if self.tracking:
                self.returned.append(q)
            else:
                q.rounds = []
            if self.accepting:
                self._submit(q.client)
        self.live = still
        self.ex.runs = [r for r in self.ex.runs if not r.done]

    def run_until(self, t_end: float) -> None:
        while time.perf_counter() < t_end:
            self.step()

    def drain(self, deadline: float, queries: bool) -> None:
        """Tick, the clients still submitting (so the load stays as it was),
        until every query submitted in the window has returned (where
        ``queries``) or the deadline passes; then stop taking queries."""
        while (queries and any(q.in_window for q in self.live)
               and time.perf_counter() < deadline):
            self.step()
        self.accepting = False
