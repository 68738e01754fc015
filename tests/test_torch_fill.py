"""Prefix-region fills in the port, on the CPU in fp32: a fill call runs its
missing regions ``max_probe_batch`` at a time in one forward, whatever their
lengths.  Each entry's K/V is that region filled alone, a round's logits are
monolithic prefill's, a fill of one length submits the reference's token
array, and the trace counters count the forwards, regions and tokens run."""
import dataclasses
import gc
import weakref

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch import trace
from repro_torch.configs import get_reduced
from repro_torch.models import LM
from repro_torch.serving import ServeEngine
from repro_torch.serving.engine import PAD, read_compare

PREFIX = "Criteria: c\nPassage B: the pivot\n"
# three suffix lengths, two rows each: three regions of three lengths in one
# class, each shared by two rows
ITEMS = ["item 1", "item 2", "item 10", "item 11", "item 100", "item 101"]
PROBES = [(PREFIX, f"Passage A: {it}\nAnswer:") for it in ITEMS]
# how each engine stores a fill: pooled runs, dense entries, a pool too small
# for every region (its last group dense), chunks of fewer rows than regions
ENGINES = {"pool": {}, "dense": {"pool_blocks": 0},
           "small_pool": {"pool_blocks": 8}, "chunked": {"max_probe_batch": 2}}


@pytest.fixture(scope="module")
def lm():
    cfg = dataclasses.replace(get_reduced("llama3-8b"), dtype="float32")
    return LM(cfg, device="cpu", generator=torch.Generator().manual_seed(0))


@pytest.fixture
def recorder():
    trace.reset()
    yield trace
    trace.reset()


def engine(lm, **kw):
    return ServeEngine(lm, max_new_tokens=4, device="cpu", **kw)


def regions(eng, probes=PROBES):
    """The class and the region keys of a round of structured probes."""
    keys, classes = set(), set()
    for prefix, suffix in probes:
        pids = tuple(eng.tok.encode(prefix))
        sids = eng.tok.encode(suffix, bos=False)
        cls = eng._pad_class(len(pids) + len(sids))
        classes.add(cls)
        keys.add(eng._region_key(pids, sids, cls))
    (cls,) = classes
    return cls, keys


def region_len(key):
    pids, pad = key
    return pad + len(pids)


def recorded_runs(eng, monkeypatch):
    """The token arrays of every fill forward ``eng`` submits."""
    arrays = []
    run = eng._run

    def record(fn, tokens, *args, **kw):
        if fn == eng._prefill_exact:
            arrays.append(tokens.copy())
        return run(fn, tokens, *args, **kw)

    monkeypatch.setattr(eng, "_run", record)
    return arrays


@pytest.mark.parametrize("kind", sorted(ENGINES))
def test_each_entry_equals_its_region_filled_alone(lm, kind):
    eng = engine(lm, **ENGINES[kind])
    cls, keys = regions(eng)
    refs, pins = eng._fill_prefix_entries(cls, keys)
    try:
        assert set(refs) == keys
        stored = {e.blocks is None for e in refs.values()}
        assert stored == {"pool": {False}, "dense": {True},
                          "small_pool": {False, True},
                          "chunked": {False}}[kind]
        for key, entry in refs.items():
            solo = engine(lm, **ENGINES[kind])
            alone = solo._fill_prefix_entries(cls, {key})[0][key]
            assert entry.length == alone.length == region_len(key)
            for got, want in zip(eng._entry_caches(entry),
                                 solo._entry_caches(alone)):
                assert got.k.shape == want.k.shape == got.v.shape
                assert got.k.shape[2] == entry.length
                torch.testing.assert_close(got.k, want.k, atol=1e-5, rtol=1e-5)
                torch.testing.assert_close(got.v, want.v, atol=1e-5, rtol=1e-5)
                assert torch.equal(got.pos, want.pos)
                assert got.pos.shape[-1] == entry.length
    finally:
        if eng.pool is not None:
            eng._release_pins(pins)


@pytest.mark.parametrize("kind", sorted(ENGINES))
def test_a_multi_length_round_equals_monolithic_prefill(lm, kind):
    eng = engine(lm, **ENGINES[kind])
    got = eng.submit_probes(PROBES)
    want = engine(lm, prefix_cache_size=0).submit_probes(PROBES)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)
    assert [read_compare(r) for r in got] == [read_compare(r) for r in want]
    assert eng.stats.prefix_misses == 3 and eng.stats.prefix_fill_submissions == 3
    again = eng.submit_probes(PROBES)               # every region resident now
    np.testing.assert_allclose(again, want, atol=1e-5, rtol=1e-5)
    eng.clear_prefix_cache()
    if eng.pool is not None:
        assert eng.pool.blocks_in_use == 0


def test_a_fill_of_one_length_submits_the_reference_array(lm, monkeypatch):
    """Regions of one length in one chunk: the forward's token array is the
    one the reference submits for that length (left PAD, then the prefix),
    byte for byte; paged admission's single region likewise."""
    eng = engine(lm)
    probes = [(f"Criteria: c\nPassage B: pivot {c}\n", f"Passage A: item {i}\nAnswer:")
              for c in "xyz" for i in range(2)]
    cls, keys = regions(eng, probes)
    assert len({region_len(k) for k in keys}) == 1
    arrays = recorded_runs(eng, monkeypatch)
    eng.submit_probes(probes)
    length = region_len(next(iter(keys)))
    want = np.full((4, length), PAD, np.int32)       # 3 regions, rows bucketed
    for r, (pids, pad) in enumerate(sorted(keys)):
        want[r, pad:] = pids
    assert len(arrays) == 1
    assert arrays[0].dtype == want.dtype and arrays[0].tobytes() == want.tobytes()

    arrays.clear()
    key = min(keys)
    eng.clear_prefix_cache()
    eng._release_pins(eng._fill_prefix_entries(cls, {key})[1])
    one = np.full((1, length), PAD, np.int32)
    one[0, key[1]:] = key[0]
    assert len(arrays) == 1 and arrays[0].tobytes() == one.tobytes()


def test_a_multi_length_fill_is_one_right_filled_forward(lm, monkeypatch):
    eng = engine(lm)
    cls, keys = regions(eng)
    assert len({region_len(k) for k in keys}) == 3
    arrays = recorded_runs(eng, monkeypatch)
    eng.submit_probes(PROBES)
    assert len(arrays) == 1
    order = sorted(keys, key=lambda k: (region_len(k), k))
    lmax = max(region_len(k) for k in keys)
    want = np.full((4, lmax), PAD, np.int32)
    for r, (pids, pad) in enumerate(order):
        want[r, pad:pad + len(pids)] = pids
    assert arrays[0].tobytes() == want.tobytes()


@pytest.mark.parametrize("kw,forwards", [
    ({"max_probe_batch": 1}, 3), ({"max_probe_batch": 2}, 2),
    ({"max_probe_batch": 1, "pool_blocks": 0}, 3)],
    ids=["pool-1", "pool-2", "dense-1"])
def test_one_chunk_of_caches_is_live_at_a_time(lm, monkeypatch, kw, forwards):
    """Fewer rows a forward than regions: each chunk's caches are written
    and dropped before the next chunk's forward runs, so a fill holds at
    most ``max_probe_batch`` rows of caches, as a probe submission does."""
    eng = engine(lm, **kw)
    cls, keys = regions(eng)
    chunks, live_at_forward = [], []
    forward = eng._fill_forward

    def tracked(chunk):
        gc.collect()
        live_at_forward.append(
            sum(any(ref() is not None for ref in refs) for refs in chunks))
        caches = forward(chunk)
        chunks.append([weakref.ref(c.k) for c in caches])
        return caches

    monkeypatch.setattr(eng, "_fill_forward", tracked)
    refs, pins = eng._fill_prefix_entries(cls, keys)
    try:
        assert set(refs) == keys
        assert live_at_forward == [0] * forwards
        gc.collect()
        assert not any(ref() for refs in chunks for ref in refs)
    finally:
        if eng.pool is not None:
            eng._release_pins(pins)


@pytest.mark.parametrize("kind,forwards", [("pool", [3]), ("chunked", [2, 1])])
def test_fill_counters_count_forwards_regions_and_tokens(lm, recorder, kind,
                                                         forwards):
    eng = engine(lm, **ENGINES[kind])
    cls, keys = regions(eng)
    order = sorted(keys, key=lambda k: (region_len(k), k))
    tokens, at = 0, 0
    for rows in forwards:
        chunk = order[at:at + rows]
        at += rows
        tokens += (1 << (rows - 1).bit_length()) * max(map(region_len, chunk))
    with profile(activities=[ProfilerActivity.CPU]):
        eng.submit_probes(PROBES)
        eng.submit_probes(PROBES)                   # resident: no forward
    c = recorder.summary()["counters"]
    assert c["engine.fill_forwards"] == len(forwards)
    assert c["engine.fill_regions"] == 3
    assert c["engine.fill_tokens"] == tokens
    assert eng.stats.prefix_fill_submissions == 3   # the reference's count
