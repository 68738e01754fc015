"""The MoE, Hymba and xLSTM families as whole models, fp32, with the
reference's weights loaded through ``from_jax_params``: ``LM`` prefill and
decode on the reduced ``mixtral-8x7b``, ``hymba-1.5b`` and ``xlstm-1.3b``
(every cache leaf, the window wrapped), parameter dtypes, and a model-backed
``llm_order_by`` on each family, whose orders, ledgers and ``ServeStats``
must equal the reference's.  Tolerance: fp32 values at 1e-4."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import LM as JLM
from repro.serving import ServeEngine as JEngine
from repro_torch.configs import get_reduced
from repro_torch.convert import from_jax_params
from repro_torch.serving import ServeEngine
from test_torch_families import FAMILIES, TOL, cfgs, check_caches, f32


@pytest.fixture(scope="module", params=FAMILIES)
def pair(request):
    jcfg, cfg = cfgs(request.param)
    jlm = JLM(jcfg)
    params = jlm.init(jax.random.PRNGKey(0))
    lm = from_jax_params(jax.tree.map(np.asarray, params), cfg, device="cpu")
    return request.param, jlm, params, lm


def tokens(seed, b, s):
    return np.random.default_rng(seed).integers(0, 256, (b, s)).astype(np.int32)


@torch.inference_mode()
def test_lm_prefill_and_decode_against_reference(pair):
    """24 positions (past the reduced window of 16), then three greedy
    decode steps; logits and every cache leaf after each step."""
    _, jlm, params, lm = pair
    toks = tokens(0, 3, 24)
    jl, jc = jlm.prefill(params, {"tokens": jnp.asarray(toks)}, reserve=4)
    tl, tc = lm.prefill({"tokens": torch.from_numpy(toks)}, reserve=4)
    np.testing.assert_allclose(f32(tl), f32(jl), **TOL)
    for a, b in zip(tc, jc):
        check_caches(a, b)
    cur = f32(jl).argmax(-1).astype(np.int32)[:, None]
    for step in range(3):
        jl, jc = jlm.decode_step(params, jc, jnp.asarray(cur), jnp.int32(24 + step))
        tl, tc = lm.decode_step(tc, torch.from_numpy(cur), 24 + step)
        np.testing.assert_allclose(f32(tl), f32(jl), **TOL)
        assert (f32(tl).argmax(-1) == f32(jl).argmax(-1)).all()
        cur = f32(jl).argmax(-1).astype(np.int32)[:, None]
    for a, b in zip(tc, jc):
        check_caches(a, b)


@torch.inference_mode()
def test_lm_forward_and_parameters_load_with_their_dtypes(pair):
    arch, jlm, params, lm = pair
    toks = tokens(1, 2, 16)
    got = lm.score_hidden({"tokens": torch.from_numpy(toks)})
    want = jlm.score_hidden(params, {"tokens": jnp.asarray(toks)})
    np.testing.assert_allclose(f32(got), f32(want), **TOL)
    # a bf16 model keeps the reference's fp32 parameters in fp32
    bf = from_jax_params(jax.tree.map(np.asarray, params), get_reduced(arch), device="cpu",
                         dtype=torch.bfloat16)
    fp32 = {name for st in bf.stacks for name, p in st.items() if p.dtype == torch.float32}
    want32 = {"norm1", "norm2", "fuse_a", "fuse_s", "ssm_dt_bias", "ssm_A_log", "ssm_D_skip",
              "gn_scale", "b_z", "b_i", "b_f", "b_o"}
    assert fp32 and fp32 <= want32
    assert bf.embed.dtype == torch.bfloat16


# ------------------------------------------------------- model-backed query
ITEMS = [f"passage {i}: " + "word " * (i % 3) + chr(97 + i) for i in range(6)]
PROMPTS = ["hi", "a longer prompt of several words", "x" * 40]


def run_query(pkg, eng, path):
    import importlib
    core = importlib.import_module(f"{pkg}.core")
    ModelOracle = importlib.import_module(f"{pkg}.core.oracles.model_oracle").ModelOracle
    o = ModelOracle(eng)
    res, rep = core.llm_order_by(core.as_keys(ITEMS), "relevance", o, descending=True,
                                 limit=3, path=path)
    return dict(result=repr(res), report=repr(rep), uids=res.uids(),
                ledger=repr((o.ledger.n_calls, o.ledger.input_tokens,
                             o.ledger.output_tokens, list(o.ledger.records))))


@pytest.mark.parametrize("path", ["pointwise", "quick"])
def test_model_backed_query_is_identical_to_the_reference(pair, path):
    """One ORDER BY query per family on each engine: the prefix cache and
    the paged pool are off for these archs on both sides (generate falls
    back to the lockstep loop), and results, ledgers and ``ServeStats``
    are equal."""
    _, jlm, params, lm = pair
    je = JEngine(jlm, params, max_new_tokens=6)
    te = ServeEngine(lm, max_new_tokens=6, device="cpu")
    assert not te.prefix_cache_enabled and not te.paged_enabled and te.pool is None
    assert te.prefix_cache_enabled == je.prefix_cache_enabled
    assert te.paged_enabled == je.paged_enabled
    assert run_query("repro_torch", te, path) == run_query("repro", je, path)
    assert te.generate(PROMPTS, max_new_per=[6, 3, 5]) == je.generate(
        PROMPTS, max_new_per=[6, 3, 5])
    names = [f.name for f in dataclasses.fields(te.stats)]
    assert {k: getattr(te.stats, k) for k in names} == {
        k: getattr(je.stats, k) for k in names}
