"""The reader of the fill counters: ``fill_regions_per_forward`` is
``engine.fill_regions / engine.fill_forwards`` of the program's summary, and
nothing where the program has no such counters, no tracer, or recorded
nothing."""
import sys

import pytest

from bench.harness.cell import metric_reader

READ = metric_reader("fill_regions_per_forward")


@pytest.fixture
def program_trace():
    from repro_torch import trace
    trace.reset()
    yield trace
    trace.reset()


def summary_of(counters):
    return lambda: {"spans": {}, "counters": counters}


@pytest.mark.parametrize("regions,forwards", [(17, 1), (80, 2), (3, 3)])
def test_reads_the_counters_ratio(program_trace, monkeypatch, regions, forwards):
    monkeypatch.setattr(program_trace, "summary", summary_of(
        {"engine.fill_regions": regions, "engine.fill_forwards": forwards,
         "engine.fill_tokens": 4096, "engine.probe_rows": 100}))
    assert READ({}) == pytest.approx(regions / forwards)


def test_nothing_without_the_counters(program_trace, monkeypatch):
    assert READ({}) is None                                   # nothing recorded
    monkeypatch.setattr(program_trace, "summary", summary_of(
        {"engine.probe_rows": 100, "engine.prefetch_filled": 8}))
    assert READ({}) is None                                   # a parent's program
    monkeypatch.setitem(sys.modules, "repro_torch.trace", None)
    assert READ({}) is None                                   # no tracer at all

