"""The slice as a whole: model-backed LLM ORDER BY through the port against the
reference, on the reduced stablelm-1.6b and llama3-8b configs in fp32 with the
reference's weights loaded through ``from_jax_params``.

Each access path, ``path="auto"`` with the judge's rationales decoded through
``BatchScheduler.generate``, and ``llm_order_by_many`` with and without a
semantic memo run through both packages in the same order; orders, ``n_calls``,
costs, ledger records, optimizer reports and ``ServeStats`` must be equal.  The
port's serving launcher prints the same order as the reference's."""
import dataclasses
import sys

import jax
import numpy as np
import pytest

from repro.configs import get_reduced as jget
from repro.models import LM as JLM
from repro.serving import ServeEngine as JEngine
from repro_torch.configs import get_reduced
from repro_torch.convert import from_jax_params
from repro_torch.serving import ServeEngine

ARCHS = ("stablelm-1.6b", "llama3-8b")
ITEMS = [f"passage {i}: " + "word " * (i % 2) + chr(97 + i) for i in range(8)]
QUERY = "relevance"
STAGES = ("pointwise", "ext_pointwise", "quick", "ext_bubble", "ext_merge", "auto",
          "many", "many_memo")


def weights(arch):
    jcfg = dataclasses.replace(jget(arch), dtype="float32")
    jlm = JLM(jcfg)
    params = jlm.init(jax.random.PRNGKey(0))
    cfg = dataclasses.replace(get_reduced(arch), dtype="float32")
    return jlm, params, from_jax_params(jax.tree.map(np.asarray, params), cfg, device="cpu")


def core(pkg):
    import importlib
    return (importlib.import_module(f"{pkg}.core"),
            importlib.import_module(f"{pkg}.core.oracles.model_oracle").ModelOracle)


def ledger(o) -> str:
    return repr((o.ledger.n_calls, o.ledger.input_tokens, o.ledger.output_tokens,
                 list(o.ledger.records)))


def stats(eng, names) -> dict:
    return {k: getattr(eng.stats, k) for k in names}


def order_kw(path):
    kw = dict(descending=True, limit=4, path=path)
    if path == "auto":
        kw.update(strategy="judge", sample_size=6)
    return kw


def run_stage(pkg, eng, stage) -> dict:
    """One stage on one package's engine: what the two must agree on."""
    c, ModelOracle = core(pkg)
    keys = c.as_keys(ITEMS)
    if stage in ("many", "many_memo"):
        oracles = [ModelOracle(eng, judge_rationale_tokens=4), ModelOracle(eng)]
        queries = [c.OrderQuery(keys, QUERY, oracles[0], **order_kw("auto")),
                   c.OrderQuery(keys, QUERY, oracles[1], **order_kw("ext_merge"))]
        memo = stage == "many_memo"
        results = c.llm_order_by_many(queries, semantic_memo=memo or None)
        out = dict(result=repr(results), report=repr([q.report for q in queries]),
                   ledger="".join(ledger(o) for o in oracles),
                   uids=[r.uids() for r in results], reason=queries[0].report.reason)
        if memo:
            out["reconciled"] = repr([o.reconciled_records() for o in oracles])
        return out
    o = ModelOracle(eng, judge_rationale_tokens=4 if stage == "auto" else 0)
    res, rep = c.llm_order_by(keys, QUERY, o, **order_kw(stage))
    return dict(result=repr(res), report=repr(rep), ledger=ledger(o), uids=res.uids(),
                reason=rep.reason if rep else None)


@pytest.fixture(scope="module", params=ARCHS)
def script(request):
    """Every stage through both engines, in the same order; each stage
    records both sides' outputs and ``ServeStats`` after it."""
    jlm, params, lm = weights(request.param)
    je = JEngine(jlm, params, max_new_tokens=8)
    te = ServeEngine(lm, max_new_tokens=8, device="cpu")
    names = [f.name for f in dataclasses.fields(te.stats)]
    stages = {}
    for stage in STAGES:
        before = te.stats.decode_tokens
        stages[stage] = dict(j=run_stage("repro", je, stage), t=run_stage("repro_torch", te, stage),
                             jstats=stats(je, names), tstats=stats(te, names),
                             decoded=te.stats.decode_tokens - before)
    return dict(stages=stages, engine=te, lm=lm, arch=request.param)


@pytest.mark.parametrize("stage", STAGES)
def test_stage_is_identical_to_the_reference(script, stage):
    s = script["stages"][stage]
    assert s["t"] == s["j"]
    assert s["tstats"] == s["jstats"]


@pytest.mark.parametrize("stage", ["auto", "many", "many_memo"])
def test_judge_rationales_decode_through_the_scheduler(script, stage):
    """Where the optimizer picks by the judge, its rationales decode through
    the engine's paged loop; where the membership gate short-circuits (the
    reduced stablelm's random weights answer every inquiry "yes"), nothing
    is decoded."""
    s = script["stages"][stage]
    judged = s["t"]["reason"] == "judge"
    assert judged == (script["arch"] == "llama3-8b")
    assert (s["decoded"] > 0) == judged
    assert script["engine"].paged_active == 0


def test_many_equals_solo_and_nothing_leaks(script):
    """The reference's contract (operator.py): each query of the shared call
    has its solo order, and the memo changes no order."""
    st = script["stages"]
    assert st["many"]["t"]["uids"] == [st["auto"]["t"]["uids"], st["ext_merge"]["t"]["uids"]]
    assert st["many_memo"]["t"]["uids"] == st["many"]["t"]["uids"]
    eng = script["engine"]
    eng.clear_prefix_cache()
    assert eng.pool.blocks_in_use == 0


def test_launcher_prints_the_reference_order(monkeypatch, capsys):
    """``repro_torch.launch.serve --device cpu --reduced`` against
    ``repro.launch.serve --reduced`` on the same weights (the port's model
    factory is handed the reference's parameters)."""
    from repro.launch import serve as jserve
    from repro_torch.launch import serve
    params = JLM(jget("stablelm-1.6b")).init(jax.random.PRNGKey(0))
    argv = ["--reduced", "--path", "auto", "--limit", "4"]
    monkeypatch.setattr(sys, "argv", ["serve", *argv])
    jserve.main()
    want = capsys.readouterr().out.splitlines()
    monkeypatch.setattr(serve, "make_lm", lambda cfg, device, seed: from_jax_params(
        jax.tree.map(np.asarray, params), cfg, device=device))
    serve.main(["--device", "cpu", *argv])
    got = capsys.readouterr().out.splitlines()
    # every line but the two that carry wall times and the reference's extra
    # sharding counters: the arch, path, calls and cost line, the optimizer's
    # choice, and the order
    assert got[:-2] == want[:-2] and len(got) == len(want) == 8
    with pytest.raises(NotImplementedError, match="distributed slice"):
        serve.main(["--device", "cpu", "--mesh", "1x1"])
