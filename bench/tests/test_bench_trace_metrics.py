"""The readers of the program's own spans and counters: each returns its
number from a summary of ``repro_torch.trace``, and nothing where the
program has no tracer or it recorded nothing; a traced tiny cell reports
every one of them."""
import sys

import pytest

from bench.harness.cell import load, metric_reader
from bench.tests import tiny

SUMMARY = {
    "spans": {
        "operator.executor_tick": {"count": 4, "total_ns": 90_000_000, "self_ns": 6_000_000},
        "operator.driver_tick": {"count": 8, "total_ns": 2_000_000, "self_ns": 2_000_000},
        "scheduler.step": {"count": 4, "total_ns": 84_000_000, "self_ns": 1_000_000},
        "engine.encode": {"count": 4, "total_ns": 3_000_000, "self_ns": 3_000_000},
        "engine.prefill": {"count": 6, "total_ns": 5_000_000, "self_ns": 5_000_000},
        "engine.prefill_cont": {"count": 4, "total_ns": 4_000_000, "self_ns": 4_000_000},
        "engine.readback": {"count": 10, "total_ns": 60_000_000, "self_ns": 60_000_000},
        "engine.scatter": {"count": 10, "total_ns": 8_000_000, "self_ns": 8_000_000},
    },
    "counters": {"scheduler.rounds": 5, "scheduler.round_wait_ns": 2_500_000,
                 "engine.probe_rows": 100, "engine.readback_bytes": 128 * 401_408,
                 "engine.prefetch_filled": 8, "engine.prefetch_used": 6},
}
EXPECTED = {
    "operator_self_ms_per_tick": (6 + 2) / 4,
    "probe_round_wait_ms": 2.5 / 5,
    "engine_host_ms_per_submission": (3 + 5 + 4 + 8) / 10,
    "readback_kb_per_probe": 128 * 401_408 / 100 / 1000,
    "prefetch_used_share": 75.0,
}


@pytest.fixture
def program_trace():
    from repro_torch import trace
    trace.reset()
    yield trace
    trace.reset()


@pytest.mark.parametrize("name", sorted(EXPECTED))
def test_reader_from_a_summary(name, program_trace, monkeypatch):
    monkeypatch.setattr(program_trace, "summary", lambda: SUMMARY)
    assert metric_reader(name)({}) == pytest.approx(EXPECTED[name])


@pytest.mark.parametrize("name", sorted(EXPECTED))
def test_reader_without_a_tracer_or_a_record(name, program_trace, monkeypatch):
    assert metric_reader(name)({}) is None                   # nothing recorded
    monkeypatch.setattr(program_trace, "summary",
                        lambda: {"spans": {}, "counters": {"engine.readback_bytes": 5}})
    assert metric_reader(name)({}) is None                   # nothing to divide by
    monkeypatch.setitem(sys.modules, "repro_torch.trace", None)
    assert metric_reader(name)({}) is None                   # a program without one


def test_a_traced_quick_cell_reports_every_program_metric(program_trace):
    cell = tiny.cell_named("stablelm-1.6b-short.nba_top10_quick")
    config, mix = load("configs", cell["config"]), load("mixes", cell["traffic"])
    tiny.shrink(config, mix)
    mix["family_args"] = {"n": 40}
    out = tiny.run(cell, config, mix, traced=True)
    assert out["correct"], out["check"]
    got = {k: v["value"] for k, v in out["metrics"].items() if k in EXPECTED}
    assert set(got) == set(EXPECTED), got
    assert got["readback_kb_per_probe"] >= config["model"]["vocab_size"] * 4 / 1000
    assert 0 < got["prefetch_used_share"] <= 100
