"""The port's ``core/`` against the reference's: the same keys (the datasets of
``core/datasets.py``), simulated oracles and queries through ``repro.core`` and
``repro_torch.core`` give byte-identical orders, ``SortResult`` fields, ledger
records and optimizer reports (compared as ``repr`` strings); inside the port
the reference's own contracts hold (sync == deferred ledgers, batched ==
sequential rounds, interleaved == solo, cascade at ``threshold=inf`` ==
single model).  Both packages raise the same exception on the same input."""
import importlib
import math

import pytest

PKGS = ("repro", "repro_torch")
PATHS = ("pointwise", "ext_pointwise", "quick", "ext_bubble", "ext_merge")
ORACLES = ("reasoning", "factual", "exact", "flaky")
SPECS = {"asc": (False, None), "desc_limit": (True, 5)}


def core(pkg):
    return importlib.import_module(f"{pkg}.core")


def oracle(pkg, name):
    c = core(pkg)
    if name == "exact":
        return c.ExactOracle()
    if name == "flaky":
        # frequent structural failures: the split-retry fallback runs
        return c.SimulatedOracle(c.OracleProfile(name="flaky", invalid_rate=0.5,
                                                 listwise_noise=0.4, score_noise=0.6))
    return c.SimulatedOracle(c.REASONING if name == "reasoning" else c.FACTUAL)


def task(pkg, n=24):
    return core(pkg).datasets.passages(n=n, seed=2)


def ledger(o) -> str:
    return repr((o.ledger.n_calls, o.ledger.input_tokens, o.ledger.output_tokens,
                 list(o.ledger.records)))


def both(fn):
    """Run ``fn(pkg)`` under each package; the two results as strings."""
    return [fn(pkg) for pkg in PKGS]


def assert_identical(fn):
    ref, port = both(fn)
    assert ref == port
    return port


# ------------------------------------------------------------ the datasets
def test_datasets_are_identical():
    def run(pkg):
        d = core(pkg).datasets
        tasks = d.benchmark_suite(seed=0) + d.dl_queries(n_queries=2, n=30)
        return repr([(t.name, t.criteria, t.descending, t.keys) for t in tasks])
    assert_identical(run)


def test_metrics_are_identical():
    def run(pkg):
        c = core(pkg)
        t = task(pkg, 40)
        res = c.llm_order_by(t.keys, t.criteria, oracle(pkg, "reasoning"), path="quick",
                             descending=t.descending)[0]
        rel = {k.uid: max(k.latent, 0.0) for k in t.keys}
        return repr((c.metrics.kendall_tau(res.order, t.descending),
                     c.metrics.ndcg_at_k(res.order, rel, 10),
                     c.metrics.kendall_tau_between(res.uids(), sorted(res.uids()))))
    assert_identical(run)


# ------------------------------------------------------- the static paths
@pytest.mark.parametrize("spec", sorted(SPECS))
@pytest.mark.parametrize("name", ORACLES)
@pytest.mark.parametrize("path", PATHS)
def test_static_path_is_byte_identical(path, name, spec):
    desc, limit = SPECS[spec]

    def run(pkg):
        c = core(pkg)
        o = oracle(pkg, name)
        t = task(pkg)
        res, rep = c.llm_order_by(t.keys, t.criteria, o, path=path, descending=desc,
                                  limit=limit,
                                  params=c.PathParams(batch_size=4, votes=3))
        assert rep is None
        return repr(res) + ledger(o)
    assert_identical(run)


# ------------------------------------------------------ the optimizer
@pytest.mark.parametrize("budget", [None, 0.05])
@pytest.mark.parametrize("strategy", ["borda", "judge", "consensus"])
def test_auto_is_byte_identical(strategy, budget):
    def run(pkg):
        c = core(pkg)
        o = oracle(pkg, "reasoning")
        t = task(pkg, 30)
        res, rep = c.llm_order_by(t.keys, t.criteria, o, path="auto",
                                  descending=True, limit=8, strategy=strategy,
                                  budget=budget, sample_size=10)
        assert rep is not None and rep.chosen is not None
        return repr(res) + repr(rep) + ledger(o)
    assert_identical(run)


# ------------------------------------------- llm_order_by_many, memo, identity
def many_queries(c, keys, oracles, auto=True):
    qs = [c.OrderQuery(keys, "relevance", oracles[i], descending=i % 2 == 0,
                       limit=(6 if i % 2 else None), path=path,
                       params=c.PathParams(batch_size=4, votes=3))
          for i, path in enumerate(PATHS)]
    if auto:
        qs.append(c.OrderQuery(keys, "relevance", oracles[len(PATHS)], path="auto",
                               descending=True, limit=6, sample_size=8,
                               strategy="borda"))
    return qs


@pytest.mark.parametrize("memo", [False, True])
def test_many_is_byte_identical(memo):
    def run(pkg):
        c = core(pkg)
        keys = task(pkg).keys
        oracles = [oracle(pkg, "reasoning") for _ in range(len(PATHS) + 1)]
        qs = many_queries(c, keys, oracles)
        results = c.llm_order_by_many(qs, semantic_memo=memo or None)
        out = repr(results) + repr([q.report for q in qs])
        return out + "".join(ledger(o) for o in oracles)
    assert_identical(run)


def test_many_equals_solo_inside_the_port():
    """Per-query order and ledger of the shared call (deferred rounds) equal
    each query run alone (sync), with and without a memo (a simulated oracle
    has no deferred rounds for the memo to serve, so it bills as solo)."""
    c = core("repro_torch")
    keys = task("repro_torch").keys
    solo = []
    for q in many_queries(c, keys, [oracle("repro_torch", "reasoning")
                                    for _ in range(len(PATHS) + 1)]):
        res, _ = c.llm_order_by(q.keys, q.criteria, q.oracle, descending=q.descending,
                                limit=q.limit, path=q.path, params=q.params,
                                sample_size=q.sample_size, strategy=q.strategy)
        solo.append((res.uids(), ledger(q.oracle)))
    for memo in (None, True):
        oracles = [oracle("repro_torch", "reasoning") for _ in range(len(PATHS) + 1)]
        results = c.llm_order_by_many(many_queries(c, keys, oracles), semantic_memo=memo)
        for (uids, led), res, o in zip(solo, results, oracles):
            assert res.uids() == uids
            assert ledger(o) == led


@pytest.mark.parametrize("path", PATHS)
def test_batched_rounds_equal_sequential_in_the_port(path):
    """The reference's contract (tests/test_batched_oracle.py): the same order
    with round batching on and off, and the same logical calls and token
    totals (record order may differ: merge interleaves windows), even under
    structural failures."""
    c = core("repro_torch")
    keys = task("repro_torch").keys
    outs = []
    for coalesce in (True, False):
        o = oracle("repro_torch", "flaky")
        res = c.make_path(path, c.PathParams(batch_size=4, votes=3, coalesce=coalesce)
                          ).execute(keys, o, c.SortSpec("c", True, 7))
        outs.append((res.uids(), o.ledger.n_calls, o.ledger.input_tokens,
                     o.ledger.output_tokens, sorted(map(repr, o.ledger.records))))
    assert outs[0] == outs[1]


@pytest.mark.parametrize("path", PATHS)
def test_cascade_at_infinite_threshold_is_the_single_model(path):
    """Cascade passthrough: byte-identical to the large profile alone, in
    both packages, and the two packages agree."""
    def run(pkg):
        c = core(pkg)
        keys = task(pkg).keys
        spec = c.SortSpec("c", True, 6)
        params = c.PathParams(batch_size=4, votes=3)
        cas = c.SimulatedCascadeOracle(threshold=math.inf)
        single = c.SimulatedOracle(c.REASONING, prices=cas.prices)
        got = c.make_path(path, params).execute(keys, cas, spec)
        want = c.make_path(path, params).execute(keys, single, spec)
        assert got.uids() == want.uids()
        assert list(cas.ledger.records) == list(single.ledger.records)
        return repr(got) + ledger(cas)
    assert_identical(run)


def test_cached_oracle_is_transparent_and_identical():
    def run(pkg):
        c = core(pkg)
        keys = task(pkg).keys
        inner = oracle(pkg, "reasoning")
        cached = c.CachingOracle(inner)
        first = c.llm_order_by(keys, "c", cached, path="quick")[0]
        again = c.llm_order_by(keys, "c", cached, path="quick")[0]
        assert first.uids() == again.uids()
        return repr((first, again)) + ledger(inner)
    assert_identical(run)


# ------------------------------------------------- the same exceptions
def test_simulated_compare_overflow_raises_in_both():
    """The reference's SimulatedOracle computes ``math.exp`` of a latent gap
    over ``compare_temp`` without a guard (simulated.py:111); the port keeps
    the arithmetic, so both raise on the same falsifying input."""
    for pkg in PKGS:
        c = core(pkg)
        keys = c.as_keys(["k0", "k1"], [97.0, -17.0])
        with pytest.raises(OverflowError):
            c.make_path("quick", c.PathParams()).execute(
                keys, oracle(pkg, "reasoning"), c.SortSpec("c"))


def test_invalid_path_and_strategy_raise_alike():
    for pkg in PKGS:
        c = core(pkg)
        keys = task(pkg, 6).keys
        with pytest.raises(KeyError):
            c.llm_order_by(keys, "c", oracle(pkg, "exact"), path="no_such_path")
