"""The port's tracer (``repro_torch.trace``) over a tiny engine, scheduler
and executor on the CPU: it records nothing and changes nothing without a
profiler; under one, every span is a ``record_function`` range of the
profile, nested by layer, whose host totals agree with the profile's own
clock, and the counters count what the program did."""
import dataclasses
import importlib.util
from collections import defaultdict
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch import trace
from repro_torch.configs import get_reduced
from repro_torch.core import (AccessPathOptimizer, OptimizerConfig, PathParams,
                              SortSpec, as_keys, make_path)
from repro_torch.core.executor import ProbePlanExecutor
from repro_torch.core.optimizer.optimizer import OptimizerDriver
from repro_torch.core.oracles.model_oracle import ModelOracle
from repro_torch.models import LM
from repro_torch.serving import BatchScheduler, ServeEngine

ITEMS = [f"item {i}: " + "word " * (i % 3) + chr(97 + i) for i in range(10)]
QUERY = "relevance"
PAIRS = [("Criteria: shared head\nItem:", f" key {c}\nRating:") for c in "abcdef"]
PROMPTS = ["a plain prompt", "another plain one"] + PAIRS
# where each span opens: the innermost program span around it (None: at the top)
PARENTS = {
    "operator.executor_tick": {None},
    "operator.driver_tick": {None},
    "scheduler.step": {"operator.executor_tick"},
    "scheduler.fills": {"scheduler.step"},
    "scheduler.probes": {"scheduler.step"},
    "engine.encode": {None, "scheduler.probes"},
    "engine.route": {None, "scheduler.probes"},
    "engine.fill": {None, "scheduler.probes", "scheduler.fills"},
    "engine.assemble": {None, "scheduler.probes"},
    "engine.prefill": {None, "scheduler.probes"},
    "engine.prefill_cont": {None, "scheduler.probes"},
    "engine.readback": {None, "scheduler.probes"},
    "engine.scatter": {None, "scheduler.probes"},
}
HARNESS_SPANS = {"operator.tick", "operator.on_tick", "scheduler.submit_probe_round",
                 "scheduler.pump", "engine.submit_probes"}


@pytest.fixture(scope="module")
def lm():
    cfg = dataclasses.replace(get_reduced("llama3-8b"), dtype="float32")
    return LM(cfg, device="cpu", generator=torch.Generator().manual_seed(3))


@pytest.fixture(autouse=True)
def clean_tracer():
    trace.reset()
    yield
    trace.reset()


def serve(lm) -> dict:
    """Direct probe submissions, then two quicksorts, a pointwise sort and an
    optimizer driver on one executor over one scheduler, to the end; returns
    what the program answered and counted, and the rounds it was sent."""
    eng = ServeEngine(lm, max_new_tokens=4, max_probe_batch=4, device="cpu")
    sched = BatchScheduler(eng)
    rounds = []
    submit = sched.submit_probe_round

    def counted(prompts, tenant="default"):
        rounds.append(len(prompts))
        return submit(prompts, tenant=tenant)

    sched.submit_probe_round = counted
    ex = ProbePlanExecutor(scheduler=sched)
    logits = [eng.submit_probes(PROMPTS), eng.submit_probes(PROMPTS[::-1])]
    keys = as_keys(ITEMS)
    spec = SortSpec(QUERY, True, 4)
    oracles = [ModelOracle(eng) for _ in range(4)]
    runs = [ex.submit_path(make_path(p, PathParams()), keys, o, spec)
            for p, o in zip(("quick", "pointwise", "quick"), oracles)]
    driver = OptimizerDriver(AccessPathOptimizer(OptimizerConfig(sample_size=6)),
                             keys, oracles[3], spec, executor=ex)
    while not (all(r.done for r in runs) and driver.done):
        ex.tick()
        driver.on_tick(ex)
    return {"logits": logits, "orders": [r.result for r in runs] + [driver.result.order],
            "ledgers": [repr(list(o.ledger.records)) for o in oracles],
            "stats": dataclasses.asdict(eng.stats), "rounds": rounds}


def profiled(lm):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = serve(lm)
    ranges = [(e.start_ns(), e.start_ns() + e.duration_ns(), e.name())
              for e in prof.profiler.kineto_results.events() if e.name() in PARENTS]
    return out, sorted(ranges, key=lambda r: (r[0], -r[1]))


@pytest.fixture(scope="module")
def runs(lm):
    trace.reset()
    plain = serve(lm)
    out, ranges = profiled(lm)
    s = trace.summary()
    trace.reset()
    return plain, out, ranges, s


def test_no_profiler_no_record_no_range_no_clock(lm, monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("the tracer worked without a profiler")

    monkeypatch.setattr(trace, "time", type("Clock", (), {"perf_counter_ns": refuse}))
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    assert trace.span("engine.encode") is trace.span("engine.route")
    serve(lm)
    assert trace.summary() == {"spans": {}, "counters": {}}


def test_results_bitwise_equal_with_and_without_a_profiler(runs):
    plain, out, _, _ = runs
    for a, b in zip(plain["logits"], out["logits"]):
        assert a.tobytes() == b.tobytes()
    for key in ("orders", "ledgers", "stats", "rounds"):
        assert plain[key] == out[key], key


def test_every_span_is_a_range_nested_by_layer(runs):
    _, _, ranges, s = runs
    assert set(s["spans"]) == set(PARENTS)
    open_ranges: list = []
    for t0, t1, name in ranges:
        while open_ranges and open_ranges[-1][1] < t1:
            open_ranges.pop()
        parent = open_ranges[-1][2] if open_ranges else None
        assert parent in PARENTS[name], (name, parent)
        open_ranges.append((t0, t1, name))


def test_span_names_are_the_harness_trace_readers_spans():
    path = Path(__file__).resolve().parents[1] / "bench" / "harness" / "trace.py"
    spec = importlib.util.spec_from_file_location("bench_trace_reader", path)
    reader = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(reader)
    for name in PARENTS:
        assert reader._is_span(name), name
    assert not set(PARENTS) & HARNESS_SPANS


def test_host_totals_agree_with_the_profile_clock(runs):
    _, _, ranges, s = runs
    total = defaultdict(int)
    n = defaultdict(int)
    for t0, t1, name in ranges:
        total[name] += t1 - t0
        n[name] += 1
    for name, v in s["spans"].items():
        assert v["count"] == n[name], name
        assert abs(v["total_ns"] - total[name]) <= max(0.05 * total[name], 200_000), name
        assert 0 <= v["self_ns"] <= v["total_ns"]


def test_counters_count_the_work(runs, lm):
    _, out, _, s = runs
    c = s["counters"]
    stats = out["stats"]
    assert c["engine.probe_rows"] == stats["probe_rows"]
    assert c["engine.readback_bytes"] == stats["probe_row_slots"] * lm.cfg.vocab_size * 4
    # every round submitted is waited for once
    assert c["scheduler.rounds"] == len(out["rounds"]) > 0
    assert c["scheduler.round_wait_ns"] > 0
    assert 0 < c["engine.prefetch_used"] <= c["engine.prefetch_filled"]


def test_readback_bytes_are_the_padded_rows_of_each_submission(lm):
    eng = ServeEngine(lm, max_new_tokens=4, max_probe_batch=4, device="cpu")
    with profile(activities=[ProfilerActivity.CPU]):
        eng.submit_probes(["one", "two", "three"])       # one class, 3 rows pad to 4
    assert trace.summary()["counters"]["engine.readback_bytes"] == 4 * lm.cfg.vocab_size * 4


def test_a_prefetched_region_is_used_once(lm):
    eng = ServeEngine(lm, max_new_tokens=4, device="cpu")
    with profile(activities=[ProfilerActivity.CPU]):
        assert eng.prefetch_prefixes(PAIRS) == 1
        assert eng.prefetch_prefixes(PAIRS) == 1            # resident: no fill
        first = eng.submit_probes(PAIRS)
        again = eng.submit_probes(PAIRS)
    c = trace.summary()["counters"]
    assert c["engine.prefetch_filled"] == 1
    assert c["engine.prefetch_used"] == 1
    assert np.array_equal(first, again)
