"""The rest of the model zoo through the port against the reference:
``attn_impl="qchunk"`` (query-blocked attention), M-RoPE, ``embeds`` input
and the encoder-decoder kinds ``enc`` / ``xdec``, on the reduced
``phi4-mini-3.8b``, ``qwen2-vl-7b`` and ``seamless-m4t-medium`` with the
reference's weights loaded through ``from_jax_params``: forward hidden
states, prefill logits and every cache leaf (the cross K / V included), a
decode step, ``LM.loss`` and its gradients, the reference's
prefill-plus-decode contract, model-backed queries whose orders, ledgers and
``ServeStats`` equal the reference engine's, the serving launcher, and
``registry.ladder()``.

Tolerances: fp32 at 1e-5 for single attention calls, 1e-4 through whole
models (summation order of the matrix products), M-RoPE angles at 1e-4 as
test_torch_layers.py holds RoPE; bf16 attention at 3e-2 (the two libraries
round a bf16 softmax at different places)."""
import dataclasses
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced as jget
from repro.models import LM as JLM
from repro.models import layers as JL
from repro.serving import ServeEngine as JEngine
from repro_torch.configs import ARCH_IDS, get_reduced
from repro_torch.configs.registry import ladder
from repro_torch.convert import from_jax_params
from repro_torch.models import LM
from repro_torch.models import layers as TL
from repro_torch.serving import ServeEngine
from repro_torch.training.tree import flatten_with_path, leaves, path_str
from test_torch_families import check_caches

ARCHS = ("phi4-mini-3.8b", "qwen2-vl-7b", "seamless-m4t-medium")
TOL = dict(atol=1e-4, rtol=1e-4)
ATOL = {"float32": 1e-5, "bfloat16": 3e-2}
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Many small tensor ops: one intra-op thread, since the suite runs
    several workers on the machine's cores and oversubscribed threads spin."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def f32(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def rnd(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


# ------------------------------------------------------------ qchunk layer
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("g", [1, 3])
@pytest.mark.parametrize("window", [0, 5])
@pytest.mark.parametrize("chunk", [4, 8])
def test_gqa_attention_qchunk_against_reference(dtype, g, window, chunk):
    """Sq 21 is no multiple of either chunk: blocks of 3 (chunk 4) and 7
    (chunk 8); with window 5 each block slices its live KV range."""
    kv, sq, hd = 2, 21, 16
    q, k, v = rnd(0, 2, sq, kv * g, hd), rnd(1, 2, sq, kv, hd), rnd(2, 2, sq, kv, hd)
    got = TL.gqa_attention_qchunk(*(torch.from_numpy(a).to(TDT[dtype]) for a in (q, k, v)),
                                  causal=True, window=window, chunk=chunk)
    want = JL.gqa_attention_qchunk(*(jnp.asarray(a, JDT[dtype]) for a in (q, k, v)),
                                   causal=True, window=window, chunk=chunk)
    assert got.dtype == TDT[dtype] and got.shape == (2, sq, kv * g, hd)
    np.testing.assert_allclose(f32(got), f32(want), atol=ATOL[dtype], rtol=ATOL[dtype])
    if dtype == "float32":
        # and the unblocked fp32 attention under the same mask
        full = TL.gqa_attention(*(torch.from_numpy(a) for a in (q, k, v)),
                                TL.causal_mask(sq, sq, window))
        np.testing.assert_allclose(f32(got), f32(full), atol=1e-5, rtol=1e-5)


# ------------------------------------------------------------------ M-RoPE
@pytest.mark.parametrize("sections,theta", [((2, 3, 3), 1e6), ((16, 24, 24), 1e6),
                                            ((4, 2, 2), 1e4)])
def test_mrope_angles_against_reference(sections, theta):
    """Three different position rows (t, h, w): each frequency group turns
    with its own row."""
    rng = np.random.default_rng(3)
    pos = np.stack([rng.integers(0, 4096, (2, 11)) for _ in range(3)]).astype(np.int32)
    rot = 2 * sum(sections)
    got = TL.rope_angles(torch.from_numpy(pos), rot, theta, sections)
    want = JL.rope_angles(jnp.asarray(pos), rot, theta, sections)
    assert got.shape == (2, 11, rot // 2) and got.dtype == torch.float32
    np.testing.assert_allclose(f32(got), f32(want), atol=1e-4, rtol=1e-6)
    # group i is plain RoPE at row i's positions
    plain = [TL.rope_angles(torch.from_numpy(pos[i]), rot, theta) for i in range(3)]
    edges = np.cumsum((0,) + sections)
    for i in range(3):
        sl = slice(int(edges[i]), int(edges[i + 1]))
        assert torch.equal(got[..., sl], plain[i][..., sl])


# ----------------------------------------------------------- whole models
@pytest.fixture(scope="module", params=ARCHS)
def pair(request):
    arch = request.param
    jcfg = dataclasses.replace(jget(arch), dtype="float32")
    jlm = JLM(jcfg)
    params = jlm.init(jax.random.PRNGKey(0))
    cfg = dataclasses.replace(get_reduced(arch), dtype="float32")
    lm = from_jax_params(jax.tree.map(np.asarray, params), cfg, device="cpu")
    return arch, jlm, params, lm


def batches(cfg, seed, b, s, enc_len=9):
    """The same batch for both packages: tokens, plus the stub frontends'
    embeddings (``embeds`` archs) or encoder input (encoder-decoder)."""
    toks = np.random.default_rng(seed).integers(0, 256, (b, s)).astype(np.int32)
    arrays = {"tokens": toks}
    if cfg.input_mode == "embeds":
        arrays = {"embeds": rnd(seed + 1, b, s, cfg.d_model), "tokens": toks}
    elif cfg.input_mode == "encdec":
        arrays["enc_embeds"] = rnd(seed + 1, b, enc_len, cfg.d_model)
    return ({k: jnp.asarray(a) for k, a in arrays.items()},
            {k: torch.from_numpy(a) for k, a in arrays.items()})


@torch.inference_mode()
def test_forward_hidden_states(pair):
    arch, jlm, params, lm = pair
    jb, tb = batches(lm.cfg, 0, 2, 13)
    if lm.cfg.mrope_sections:
        # explicit (3, B, S) positions, three different rows
        pos = np.stack([np.arange(13) + 5 * i for i in range(3)])[:, None].repeat(2, 1)
        jb["positions"] = jnp.asarray(pos.astype(np.int32))
        tb["positions"] = torch.from_numpy(pos.astype(np.int32))
    jx, _ = jlm.forward(params, jb, mode="train")
    tx, caches = lm.forward(tb, mode="train")
    assert caches is None and tx.shape == (2, 13, lm.cfg.d_model)
    np.testing.assert_allclose(f32(tx), f32(jx), **TOL)


@torch.inference_mode()
def test_prefill_caches_and_decode_step(pair):
    """Prefill logits and every cache leaf (``xdec``: the ring and the cross
    K / V over the encoder's 9 positions), then a decode step by token id and,
    for ``embeds`` archs, one by embedding."""
    arch, jlm, params, lm = pair
    jb, tb = batches(lm.cfg, 1, 3, 16)
    jl, jc = jlm.prefill(params, jb, reserve=4)
    tl, tc = lm.prefill(tb, reserve=4)
    np.testing.assert_allclose(f32(tl), f32(jl), **TOL)
    for a, b in zip(tc, jc):
        check_caches(a, b)
    if lm.cfg.input_mode == "encdec":
        kvc, xk, xv = tc[0]
        assert xk.shape == xv.shape == (2, 3, 9, lm.cfg.n_kv_heads, lm.cfg.hd)
    steps = [f32(jl).argmax(-1).astype(np.int32)[:, None]]
    if lm.cfg.input_mode == "embeds":
        steps.append(rnd(7, 3, 1, lm.cfg.d_model))
    for i, step in enumerate(steps):
        jl, jc = jlm.decode_step(params, jc, jnp.asarray(step), jnp.int32(16 + i))
        tl, tc2 = lm.decode_step(tc, torch.from_numpy(step), 16 + i)
        assert tc2[0] is tc[0] or tc2[0][0] is tc[0][0]
        np.testing.assert_allclose(f32(tl), f32(jl), **TOL)
        assert (f32(tl).argmax(-1) == f32(jl).argmax(-1)).all()
    for a, b in zip(tc, jc):
        check_caches(a, b)


def test_loss_and_gradients(pair):
    """``LM.loss`` over the decoder tokens with the arch's own inputs
    (embeddings for ``qwen2-vl``, the encoder's input for ``seamless``), and
    every gradient, the encoder's included, against ``jax.value_and_grad``."""
    arch, jlm, params, lm = pair
    jb, tb = batches(lm.cfg, 2, 2, 20)
    (jloss, _), jgrads = jax.value_and_grad(lambda p: jlm.loss(p, jb), has_aux=True)(params)
    loss, aux = lm.loss(tb)
    np.testing.assert_allclose(float(loss.detach()), float(jloss), **TOL)
    assert float(aux["tokens"]) == 2 * 19
    tree = lm.param_tree()
    if lm.cfg.enc_pattern:
        assert set(tree) >= {"enc_stacks", "enc_norm"}
    grads = torch.autograd.grad(loss, leaves(tree), allow_unused=True, materialize_grads=True)
    jleaves = jax.tree.leaves(jgrads)
    assert len(grads) == len(jleaves)
    for (path, _), g, jg in zip(flatten_with_path(tree), grads, jleaves):
        assert g.shape == jg.shape, path
        np.testing.assert_allclose(f32(g), f32(jg), **TOL, err_msg=path_str(path))


@torch.inference_mode()
def test_prefill_plus_decode_equals_forward(pair):
    """The reference's contract (tests/test_models_smoke.py), inside the
    port: a 16-position prefill plus one decode step against the 17-position
    forward's last logits."""
    _, _, _, lm = pair
    _, full = batches(lm.cfg, 3, 2, 17)
    ref = lm._head(lm.forward(full, mode="train")[0])[:, -1]
    if lm.cfg.input_mode == "embeds":
        pre, step = {"embeds": full["embeds"][:, :16]}, full["embeds"][:, 16:]
    else:
        pre = {k: (v[:, :16] if k == "tokens" else v) for k, v in full.items()}
        step = full["tokens"][:, 16:]
    _, caches = lm.prefill(pre, reserve=4)
    logits, _ = lm.decode_step(caches, step, 16)
    err = float((ref - logits).abs().max()) / (float(ref.abs().max()) + 1e-6)
    assert err < 1e-5, err


def test_bf16_model_keeps_the_reference_fp32_parameters(pair):
    arch, _, params, _ = pair
    bf = from_jax_params(jax.tree.map(np.asarray, params), get_reduced(arch), device="cpu",
                         dtype=torch.bfloat16)
    stacks = list(bf.stacks) + list(bf.enc_stacks or [])
    fp32 = {name for st in stacks for name, p in st.items() if p.dtype == torch.float32}
    want = {"norm1", "norm2"} | ({"norm_x"} if arch == "seamless-m4t-medium" else set())
    assert fp32 == want
    assert bf.final_norm.dtype == torch.float32 and bf.embed.dtype == torch.bfloat16
    if bf.enc_norm is not None:
        assert bf.enc_norm.dtype == torch.float32


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


def stats(eng) -> dict:
    return {f.name: getattr(eng.stats, f.name) for f in dataclasses.fields(eng.stats)}


def test_model_backed_query_is_identical_to_the_reference(pair):
    """One ORDER BY query and a ``generate`` per arch on each engine, equal
    results, ledgers and ``ServeStats``.  phi4-mini takes the prefix cache
    and the paged pool; the others monolithic prefill and the lockstep
    loop, which carries ``xdec``'s cross K / V from prefill through
    decode."""
    arch, jlm, params, lm = pair
    je = JEngine(jlm, params, max_new_tokens=6)
    te = ServeEngine(lm, max_new_tokens=6, device="cpu")
    tokens_only = arch == "phi4-mini-3.8b"
    assert te.prefix_cache_enabled == je.prefix_cache_enabled == tokens_only
    assert te.paged_enabled == je.paged_enabled == tokens_only
    assert run_query("repro_torch", te, "pointwise") == run_query("repro", je, "pointwise")
    assert te.generate(PROMPTS, max_new_per=[6, 3, 5]) == je.generate(
        PROMPTS, max_new_per=[6, 3, 5])
    assert stats(te) == {k: v for k, v in stats(je).items() if k in stats(te)}


@torch.inference_mode()
def test_batched_probes_equal_one_at_a_time(pair):
    """A row's padding depends on its own length only, so a batched round
    agrees with one-at-a-time submissions (logits at 1e-5: torch may block a
    matrix product differently by batch size)."""
    _, _, _, lm = pair
    eng = ServeEngine(lm, max_new_tokens=4, prefix_cache_size=0, device="cpu")
    prompts = ["short", "a somewhat longer probe prompt", "x" * 40, "mid length one"]
    batched = eng.submit_probes(prompts)
    single = np.concatenate([eng.submit_probes([p]) for p in prompts])
    np.testing.assert_allclose(batched, single, atol=1e-5, rtol=1e-5)
    assert (batched.argmax(-1) == single.argmax(-1)).all()


def test_qchunk_model_and_engine_against_reference():
    """phi4-mini as ``attn_impl="qchunk"`` with 4-position query blocks:
    prefill logits against the reference's qchunk model and the port's own
    einsum model; the engine turns the prefix cache and the paged pool off
    and decodes through the lockstep loop, as the reference's does."""
    jcfg = dataclasses.replace(jget("phi4-mini-3.8b"), dtype="float32", attn_impl="qchunk",
                               attn_chunk=4)
    cfg = dataclasses.replace(get_reduced("phi4-mini-3.8b"), dtype="float32",
                              attn_impl="qchunk", attn_chunk=4)
    jlm = JLM(jcfg)
    params = jlm.init(jax.random.PRNGKey(0))
    host = jax.tree.map(np.asarray, params)
    lm = from_jax_params(host, cfg, device="cpu")
    einsum = from_jax_params(host, dataclasses.replace(cfg, attn_impl="einsum"), device="cpu")
    jb, tb = batches(cfg, 4, 2, 22)
    with torch.inference_mode():
        tl, _ = lm.prefill(tb)
        np.testing.assert_allclose(f32(tl), f32(jlm.prefill(params, jb)[0]), **TOL)
        np.testing.assert_allclose(f32(tl), f32(einsum.prefill(tb)[0]), **TOL)
    je = JEngine(jlm, params, max_new_tokens=5)
    te = ServeEngine(lm, max_new_tokens=5, device="cpu")
    assert not te.prefix_cache_enabled and not te.paged_enabled and te.pool is None
    assert not je.prefix_cache_enabled and not je.paged_enabled
    assert te.generate(PROMPTS) == je.generate(PROMPTS)
    assert te.submit_probes(PROMPTS).argmax(-1).tolist() == \
        np.asarray(je.submit_probes(PROMPTS)).argmax(-1).tolist()


# ---------------------------------------------------------------- launcher
@pytest.mark.parametrize("arch", ARCHS)
def test_launcher_serves_each_arch_on_the_cpu(arch, monkeypatch, capsys):
    """``repro_torch.launch.serve --device cpu --reduced --arch <id>``
    against ``repro.launch.serve --reduced --arch <id>`` on the same (bf16)
    weights: the arch, path, calls and cost line and the order are equal."""
    from repro.launch import serve as jserve
    from repro_torch.launch import serve
    params = JLM(jget(arch)).init(jax.random.PRNGKey(0))
    argv = ["--reduced", "--arch", arch, "--path", "pointwise", "--limit", "3"]
    monkeypatch.setattr(sys, "argv", ["serve", *argv])
    jserve.main()
    want = capsys.readouterr().out.splitlines()
    monkeypatch.setattr(serve, "make_lm", lambda cfg, device, seed: from_jax_params(
        jax.tree.map(np.asarray, params), cfg, device=device))
    serve.main(["--device", "cpu", *argv])
    got = capsys.readouterr().out.splitlines()
    assert got[0].startswith(f"arch={get_reduced(arch).name} path=pointwise")
    assert got[:-2] == want[:-2] and len(got) == len(want) == 6


# ------------------------------------------------------------------ ladder
def test_registry_ladder_rungs_are_known_archs_smallest_first():
    """tests/test_cascade.py's ladder contract, in the port."""
    rungs = ladder()
    assert rungs == ["stablelm-1.6b", "llama3-8b", "mixtral-8x22b"]
    assert all(r in ARCH_IDS for r in rungs)
    assert rungs[0] == "stablelm-1.6b"
    from repro.configs.registry import ladder as jladder
    assert rungs == jladder()


def test_registry_ladder_rungs_all_instantiate_reduced_configs():
    for arch in ladder():
        cfg = get_reduced(arch)
        assert cfg.n_layers >= 1 and cfg.vocab_size >= 256
        lm = LM(cfg, device="cpu")
        assert lm.cfg is cfg and lm.embed.shape == (cfg.vocab_size, cfg.d_model)
