"""The slice as a whole: repro_torch ServeEngine against the reference engine
on the reduced llama3 config in fp32, with the reference's weights loaded
through ``from_jax_params``, then the reference's own contracts re-asserted
inside the port.

Generated strings, ``ServeStats`` and pool counters are host arithmetic and
must be equal; probe logits are held to 1e-4 (summation order of fp32 matrix
products differs between the libraries)."""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_reduced as jget
from repro.models import LM as JLM
from repro.serving import ServeEngine as JEngine
from repro_torch.configs import get_reduced
from repro_torch.convert import from_jax_params
from repro_torch.models import LM
from repro_torch.serving import PoolExhausted, ServeEngine
from repro_torch.serving import engine as engmod

PROMPTS = ["hi", "a mid-sized prompt", ("shared head for two rows ", "tail one"),
           ("shared head for two rows ", "tail two")]
LIMITS = [6, 3, 6, 5]
# equal-length items share one (prefix, start) region; the last one does not
PIVOT_PAIRS = [("alpha item", "pivot passage"), ("bravo item", "pivot passage"),
               ("gamma item", "pivot passage"), ("a longer delta item", "pivot passage")]
POOL_COUNTERS = ("free_blocks", "blocks_in_use", "peak_in_use", "total_allocs",
                 "total_leased", "lease_shortfalls", "total_stashed", "total_unstashed")


def stats_dict(stats):
    return dataclasses.asdict(stats)


def pool_dict(pool):
    return {k: getattr(pool, k) for k in POOL_COUNTERS}


@pytest.fixture(scope="module")
def models():
    jcfg = dataclasses.replace(jget("llama3-8b"), dtype="float32")
    jlm = JLM(jcfg)
    params = jlm.init(jax.random.PRNGKey(0))
    cfg = dataclasses.replace(get_reduced("llama3-8b"), dtype="float32")
    lm = from_jax_params(jax.tree.map(np.asarray, params), cfg, device="cpu")
    return jlm, params, lm


@pytest.fixture(scope="module")
def lm(models):
    return models[2]


@pytest.fixture(scope="module")
def lm_bf16():
    return LM(get_reduced("llama3-8b"), device="cpu",
              generator=torch.Generator().manual_seed(1))


def engine(lm, **kw):
    kw.setdefault("max_new_tokens", 8)
    return ServeEngine(lm, device="cpu", **kw)


# ------------------------------------------------------ against the reference
@pytest.fixture(scope="module")
def script(models):
    """One script through both engines; every stage records outputs, stats
    and pool counters of both sides."""
    jlm, params, lm = models
    je = JEngine(jlm, params, max_new_tokens=8)
    te = engine(lm)
    stages = {}

    def record(name, jout, tout):
        stages[name] = dict(
            j=jout, t=tout, jstats=stats_dict(je.stats), tstats=stats_dict(te.stats),
            jpool=pool_dict(je.pool), tpool=pool_dict(te.pool),
            jlru=list(je._prefix_lru), tlru=list(te._prefix_lru))

    record("generate", je.generate(PROMPTS, max_new_per=LIMITS),
           te.generate(PROMPTS, max_new_per=LIMITS))
    record("lockstep", je.generate_lockstep(PROMPTS[:2], max_new=4),
           te.generate_lockstep(PROMPTS[:2], max_new=4))
    probes = [je._compare_parts(a, b, "quality") for a, b in PIVOT_PAIRS]
    assert probes == [te._compare_parts(a, b, "quality") for a, b in PIVOT_PAIRS]
    record("probes_cold", je.submit_probes(probes), te.submit_probes(probes))
    record("probes_warm", je.submit_probes(probes[:3] + ["plain one"]),
           te.submit_probes(probes[:3] + ["plain one"]))
    record("verbs", (je.compare_many(PIVOT_PAIRS, "quality"),
                     je.rank_window(["aa", "bbb", "c"], "size")),
           (te.compare_many(PIVOT_PAIRS, "quality"),
            te.rank_window(["aa", "bbb", "c"], "size")))
    je.clear_prefix_cache(), te.clear_prefix_cache()
    record("cleared", None, None)
    return stages


@pytest.mark.parametrize("stage", ["generate", "lockstep", "probes_cold", "probes_warm",
                                   "verbs", "cleared"])
def test_stats_and_pool_counters_equal_field_by_field(script, stage):
    s = script[stage]
    assert set(s["jstats"]) == set(s["tstats"])
    for name, value in s["tstats"].items():
        assert value == s["jstats"][name], name
    assert s["tpool"] == s["jpool"]
    assert s["tlru"] == s["jlru"]


@pytest.mark.parametrize("kw", [{}, {"max_probe_batch": 2}, {"pool_blocks": 8}],
                         ids=["pool", "chunked", "small_pool"])
def test_a_multi_length_fill_keeps_the_reference_accounting(models, kw):
    """A round whose shared regions span three lengths: the port prefills
    them in fewer forwards than the reference, and still counts the
    reference's plan (``ServeStats``, pool counters, LRU order), cold and
    warm."""
    jlm, params, lm = models
    je, te = JEngine(jlm, params, max_new_tokens=8, **kw), engine(lm, **kw)
    probes = [("Criteria: c\nPassage B: the pivot\n", f"Passage A: item {i}\nAnswer:")
              for i in (1, 2, 10, 11, 100, 101)]
    for rnd in range(2):
        got, want = te.submit_probes(probes), je.submit_probes(probes)
        np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)
        assert stats_dict(te.stats) == stats_dict(je.stats)
        assert pool_dict(te.pool) == pool_dict(je.pool)
        assert list(te._prefix_lru) == list(je._prefix_lru)
        if rnd == 0:
            assert te.stats.prefix_fill_submissions == 3
    assert te.stats.prefix_hits >= 1


@pytest.mark.parametrize("stage", ["generate", "lockstep"])
def test_generated_strings_equal(script, stage):
    assert script[stage]["t"] == script[stage]["j"]
    assert all(isinstance(o, str) for o in script[stage]["t"])


@pytest.mark.parametrize("stage", ["probes_cold", "probes_warm"])
def test_probe_logits_match(script, stage):
    got, want = script[stage]["t"], script[stage]["j"]
    assert got.shape == want.shape and got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)
    assert (got.argmax(-1) == want.argmax(-1)).all()


def test_prefix_cache_was_hit_and_verbs_agree(script):
    assert script["probes_warm"]["tstats"]["prefix_hits"] > 0
    assert script["verbs"]["t"][0] == script["verbs"]["j"][0]
    assert [int(i) for i in script["verbs"]["t"][1]] == [int(i) for i in script["verbs"]["j"][1]]
    assert script["cleared"]["tpool"]["blocks_in_use"] == 0


# ------------------------------------------- the reference's contracts, inside
def test_batched_probes_equal_sequential(lm):
    """A row's padding depends on its own length only, so a batched round
    agrees with one-at-a-time submissions: tokens and read-outs equal, logits
    at 1e-5 (on the CPU torch may block a matrix product differently by batch
    size, so bitwise equality is not promised)."""
    eng = engine(lm, prefix_cache_size=0)
    prompts = ["short", "a somewhat longer probe prompt", "x" * 40, "mid length one"]
    batched = eng.submit_probes(prompts)
    single = np.concatenate([eng.submit_probes([p]) for p in prompts])
    np.testing.assert_allclose(batched, single, atol=1e-5, rtol=1e-5)
    assert (batched.argmax(-1) == single.argmax(-1)).all()
    assert eng.stats.calls == 3 + 4           # three pad classes, then singles


def test_prefix_cached_equals_monolithic(lm):
    probes = [("Criteria: c\nPassage B: the pivot\n", f"Passage A: item {i}\nAnswer:")
              for i in range(5)]
    cached, mono = engine(lm), engine(lm, prefix_cache_size=0)
    a, b = cached.submit_probes(probes), mono.submit_probes(probes)
    np.testing.assert_allclose(a, b, atol=1e-5, rtol=1e-5)
    assert cached.stats.prefix_misses == 1 and cached.stats.prefix_fill_submissions == 1
    assert cached.stats.prefix_tokens_saved > 0 and mono.stats.prefix_misses == 0
    again = cached.submit_probes(probes)
    assert cached.stats.prefix_hits == 1
    np.testing.assert_array_equal(again, a)
    cached.clear_prefix_cache()
    assert cached.pool.blocks_in_use == 0


def test_dense_prefix_entries_without_a_pool(lm):
    """pool_blocks=0: prefix entries hold dense KV, generate falls back to
    lockstep."""
    probes = [("Criteria: c\nPassage B: the pivot\n", f"Passage A: item {i}\nAnswer:")
              for i in range(3)]
    nopool, mono = engine(lm, pool_blocks=0), engine(lm, prefix_cache_size=0)
    assert nopool.pool is None and not nopool.paged_enabled
    np.testing.assert_allclose(nopool.submit_probes(probes), mono.submit_probes(probes),
                               atol=1e-5, rtol=1e-5)
    assert next(iter(nopool._prefix_lru.values())).caches is not None
    assert nopool.generate(["hi"], max_new=3) == mono.generate_lockstep(["hi"], max_new=3)


def test_locality_off_and_max_probe_batch_chunking(lm):
    probes = [("Criteria: c\nPassage B: the pivot\n", f"Passage A: item {i}\nAnswer:")
              for i in range(5)]
    base = engine(lm).submit_probes(probes)
    reactive = engine(lm, locality=False)
    np.testing.assert_allclose(reactive.submit_probes(probes), base, atol=1e-5, rtol=1e-5)
    chunked = engine(lm, max_probe_batch=2)
    np.testing.assert_allclose(chunked.submit_probes(probes), base, atol=1e-5, rtol=1e-5)
    assert chunked.stats.calls == 3 and chunked.stats.probe_rows == 5
    assert engine(lm).submit_probes([]).shape == (0, lm.cfg.vocab_size)


def test_paged_generate_equals_solo_lockstep(lm):
    eng = engine(lm)
    outs = eng.generate(PROMPTS, max_new_per=LIMITS)
    solo = [eng.generate_lockstep([p], max_new_per=[l])[0]
            for p, l in zip(PROMPTS, LIMITS)]
    assert outs == solo
    assert eng.generate(PROMPTS[:2], max_new_per=[0, 2])[0] == ""
    eng.clear_prefix_cache()
    assert eng.pool.blocks_in_use == 0


def test_continuous_batching_admits_into_vacated_rows(lm):
    """More requests than decode rows: later ones are admitted as earlier
    ones retire, and every output still equals its solo run."""
    eng = engine(lm, max_decode_rows=2)
    prompts = [f"request number {i}" for i in range(5)]
    limits = [2, 6, 3, 5, 4]
    outs = eng.generate(prompts, max_new_per=limits)
    ref = engine(lm)
    assert outs == [ref.generate_lockstep([p], max_new_per=[l])[0]
                    for p, l in zip(prompts, limits)]
    assert eng.pool.blocks_in_use == 0 and eng.paged_active == 0


@pytest.mark.parametrize("mode", ["check", True])
def test_kernel_switch_tokens_equal_dense(lm, mode):
    dense, kern = engine(lm), engine(lm, paged_kernel=mode)
    assert kern.generate(PROMPTS, max_new=6) == dense.generate(PROMPTS, max_new=6)
    assert stats_dict(kern.stats) == stats_dict(dense.stats)
    kern.clear_prefix_cache()
    assert kern.pool.blocks_in_use == 0


def test_check_mode_holds_in_bf16(lm_bf16):
    eng = engine(lm_bf16, paged_kernel="check")
    outs = eng.generate(PROMPTS, max_new=6)
    assert outs == engine(lm_bf16).generate(PROMPTS, max_new=6)


@pytest.mark.parametrize("mode", ["check", True])
def test_paged_kernel_switch_rejects_non_paged_engine(lm, mode):
    with pytest.raises(ValueError, match="paged_kernel"):
        engine(lm, pool_blocks=0, paged_kernel=mode)


def test_check_mode_catches_a_broken_kernel(lm_bf16, monkeypatch):
    eng = engine(lm_bf16, paged_kernel="check")
    monkeypatch.setattr(engmod, "PAGED_KERNEL_ATOL", 0.0)
    monkeypatch.setattr(engmod, "PAGED_KERNEL_RTOL", 0.0)
    with pytest.raises(AssertionError):
        eng.generate(["tolerance tripwire " + "t" * 20], max_new=6)


def test_suspend_resume_continues_identically(lm):
    eng = engine(lm)
    want = eng.generate(PROMPTS[:2], max_new=7)
    rids = eng.paged_admit([(p, 7) for p in PROMPTS[:2]])
    done = {}
    done.update(eng.paged_step())
    done.update(eng.paged_step())
    s = eng.paged_suspend(rids[0])
    assert eng.paged_active == 1 and eng.stats.preempt_suspends == 1
    assert eng.stats.preempt_blocks_stashed == s.n_blocks
    done.update(eng.paged_step())
    assert eng.paged_resume(s) == rids[0] and eng.stats.preempt_resumes == 1
    while eng.paged_active:
        done.update(eng.paged_step())
    done.update(eng.paged_step())
    assert [done[r] for r in rids] == want
    eng.clear_prefix_cache()
    assert eng.pool.blocks_in_use == 0


def test_prefetch_prefixes_warms_the_lru(lm):
    eng = engine(lm)
    probes = [eng.score_parts(f"text {i}", "clarity") for i in range(3)]
    assert eng.prefetch_prefixes(probes + ["plain"]) == 1
    assert eng.stats.prefix_misses == 1 and eng.stats.calls == 0
    eng.score([f"text {i}" for i in range(3)], "clarity")
    assert eng.stats.prefix_hits == 1
    assert eng.yes_no_many(["Is water wet? Answer:"]) in ([True], [False])


def test_request_larger_than_the_pool_raises(lm):
    eng = engine(lm, pool_blocks=4)
    with pytest.raises(PoolExhausted):
        eng.generate(["p" * 100], max_new=8)
    assert eng.pool.blocks_in_use == 0


def test_device_rule_and_unported_arguments(lm):
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            ServeEngine(lm)
    # a mesh serves (tests/test_torch_distributed.py); the paged kernel on
    # one is refused, as the reference refuses it
    from repro_torch.launch.mesh import make_local_mesh
    with pytest.raises(ValueError, match="sharded engine"):
        ServeEngine(lm, device="cpu", paged_kernel=True,
                    mesh=make_local_mesh(1, 1, device="cpu"))
