"""The port's training path against the reference's, fp32, with the
reference's weights loaded through ``from_jax_params``: ``LM.loss`` and every
gradient against ``jax.value_and_grad`` for each reduced family (the Hymba
SSM scan differentiated), under every ``remat`` setting; one AdamW step; the
three schedules; int8 error-feedback compression; the MoE router's auxiliary
loss; ``DataPipeline`` batches; checkpoint files and cross-restores.  The
contracts of the reference's own training tests, inside the port:
test_torch_trainer.py.

Tolerances: loss and gradients 1e-4 (summation order of the matrix
products; the reference is evaluated once per family, its ``remat`` changes
only what XLA keeps between the passes); the optimizer step 1e-5 (the
gradient norm is a sum in another order); the schedules bitwise, but for
``cos``, whose last bit may differ (1e-6 relative); compression, pipeline
batches and checkpoint files bitwise."""
import dataclasses
import filecmp
import functools
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced as jget
from repro.data import DataConfig as JDataConfig, DataPipeline as JPipeline
from repro.models import LM as JLM
from repro.models import moe as JMOE
from repro.training import checkpoint as jckpt
from repro.training import compression as jcomp
from repro.training import optimizer as jopt
from repro_torch.configs import get_reduced
from repro_torch.convert import from_jax_params, opt_state_from_jax, to_tensor, tree_from_jax
from repro_torch.data import DataConfig, DataPipeline
from repro_torch.models import moe as TMOE
from repro_torch.training import checkpoint as tckpt
from repro_torch.training import compression as tcomp
from repro_torch.training import optimizer as topt
from repro_torch.training.tree import leaves, path_str, flatten_with_path

FAMILIES = ("stablelm-1.6b", "llama3-8b", "minicpm-2b", "mixtral-8x7b", "xlstm-1.3b",
            "hymba-1.5b", "phi4-mini-3.8b", "qwen2-vl-7b", "seamless-m4t-medium")
TOL = dict(atol=1e-4, rtol=1e-4)


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


def np_tree(tree):
    return jax.tree.map(np.asarray, tree)


@functools.lru_cache(maxsize=None)
def reference(arch):
    """The reference's fp32 model, parameters, a batch whose 139 target
    tokens fill one loss chunk of 128 and a remainder (an encoder-decoder
    also gets 16 positions of encoder input), and its loss and gradients."""
    jcfg = dataclasses.replace(jget(arch), dtype="float32")
    jlm = JLM(jcfg)
    params = jlm.init(jax.random.PRNGKey(0))
    rng = np.random.default_rng(0)
    toks = {"tokens": rng.integers(0, jcfg.vocab_size, (2, 140)).astype(np.int32)}
    if jcfg.enc_pattern:
        toks["enc_embeds"] = rng.standard_normal((2, 16, jcfg.d_model)).astype(np.float32)
    (loss, aux), grads = jax.value_and_grad(
        lambda p: jlm.loss(p, {k: jnp.asarray(a) for k, a in toks.items()}),
        has_aux=True)(params)
    return params, toks, float(loss), float(aux["tokens"]), jax.tree.leaves(grads)


def port_lm(arch, params, remat="full"):
    cfg = dataclasses.replace(get_reduced(arch), dtype="float32", remat=remat)
    return from_jax_params(np_tree(params), cfg, device="cpu")


# ------------------------------------------------------- loss and gradients
@pytest.mark.parametrize("remat", ["none", "dots", "full"])
@pytest.mark.parametrize("arch", FAMILIES)
def test_loss_and_gradients_against_jax_value_and_grad(arch, remat):
    params, toks, jloss, jtokens, jgrads = reference(arch)
    lm = port_lm(arch, params, remat)
    loss, aux = lm.loss({k: torch.from_numpy(a) for k, a in toks.items()})
    value = float(loss.detach())
    assert loss.dtype == torch.float32 and loss.dim() == 0 and torch.isfinite(loss)
    assert aux["loss"] is loss and float(aux["tokens"]) == jtokens == 2 * 139
    np.testing.assert_allclose(value, jloss, **TOL)
    flat = leaves(lm.param_tree())
    assert all(p.requires_grad for p in flat)
    grads = torch.autograd.grad(loss, flat, allow_unused=True, materialize_grads=True)
    assert len(grads) == len(jgrads)
    for (path, _), g, jg in zip(flatten_with_path(lm.param_tree()), grads, jgrads):
        assert g.shape == jg.shape, path
        np.testing.assert_allclose(f32(g), f32(jg), **TOL, err_msg=path_str(path))
    # LM.loss skips final_norm, as the reference does: no gradient reaches it
    by_path = {path: g for (path, _), g in zip(flatten_with_path(lm.param_tree()), grads)}
    assert not f32(by_path[("final_norm",)]).any()


# ---------------------------------------------------------------- optimizer
@pytest.mark.parametrize("sched", ["cosine", "wsd", "const"])
def test_schedule_equals_reference(sched):
    cfg = dict(lr=3e-3, schedule=sched, warmup_steps=10, total_steps=100,
               decay_start_frac=0.8)
    jc, tc = jopt.OptimConfig(**cfg), topt.OptimConfig(**cfg)
    got = np.array([float(topt.schedule(tc, s)) for s in range(0, 121)], np.float32)
    want = np.array([float(jopt.schedule(jc, jnp.asarray(s))) for s in range(0, 121)],
                    np.float32)
    if sched == "cosine":      # cos may differ in its last bit, 1 + cos near 0 spreads it
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
        assert (got[:11] == want[:11]).all()       # warmup: no cos yet
    else:
        assert got.tobytes() == want.tobytes()


def test_one_adamw_step_against_reference():
    """Two steps from the reference's moments (the second with non-zero
    moments and bias corrections), weight decay on the stacked norm scales
    as in the reference."""
    params, toks, _, _, jgrads_flat = reference("llama3-8b")
    jgrads = jax.tree.unflatten(jax.tree.structure(params), jgrads_flat)
    cfg = dict(lr=1e-2, schedule="cosine", warmup_steps=1, total_steps=10, grad_clip=0.05)
    jstate = jopt.init_opt_state(params)
    jp = params
    lm = port_lm("llama3-8b", params)
    tstate = opt_state_from_jax(np_tree(jstate))
    for _ in range(2):
        jp, jstate, jinfo = jopt.apply_updates(jp, jgrads, jstate, jopt.OptimConfig(**cfg))
        _, tstate, tinfo = topt.apply_updates(lm.param_tree(), tree_from_jax(np_tree(jgrads)),
                                              tstate, topt.OptimConfig(**cfg))
        assert int(tstate["step"]) == int(jstate["step"])
        assert float(tinfo["lr"]) == float(jinfo["lr"])
        np.testing.assert_allclose(float(tinfo["grad_norm"]), float(jinfo["grad_norm"]),
                                   rtol=1e-6)
        for a, b in zip(leaves(lm.param_tree()), jax.tree.leaves(jp)):
            np.testing.assert_allclose(f32(a), f32(b), atol=1e-5, rtol=1e-5)
        for key in ("m", "v"):
            for a, b in zip(leaves(tstate[key]), jax.tree.leaves(jstate[key])):
                np.testing.assert_allclose(f32(a), f32(b), atol=1e-5, rtol=1e-5)
    # the stacked (n, D) norm scales were decayed, final_norm (D,) was not
    assert float(jinfo["grad_norm"]) > cfg["grad_clip"]            # clipping engaged


def test_compressed_grads_against_reference():
    params, _, _, _, jgrads_flat = reference("stablelm-1.6b")
    jgrads = jax.tree.unflatten(jax.tree.structure(params), jgrads_flat)
    rng = np.random.default_rng(3)
    jerr = jax.tree.map(lambda g: jnp.asarray(
        rng.standard_normal(g.shape).astype(np.float32) * 1e-3), jgrads)
    jdeq, jerr2 = jcomp.compressed_grads(jgrads, jerr)
    tg, te = tree_from_jax(np_tree(jgrads)), tree_from_jax(np_tree(jerr))
    tdeq, terr2 = tcomp.compressed_grads(tg, te)
    for a, b in zip(leaves(tdeq) + leaves(terr2), jax.tree.leaves(jdeq) + jax.tree.leaves(jerr2)):
        np.testing.assert_array_equal(f32(a), f32(b))
    qs, scales, _ = tcomp.compress_tree(tg, te)
    jqs, jscales, _ = jcomp.compress_tree(jgrads, jerr)
    for a, b in zip(leaves(qs), jax.tree.leaves(jqs)):
        assert a.dtype == torch.int8 and (a.numpy() == np.asarray(b)).all()
    assert [float(s) for s in leaves(scales)] == [float(s) for s in jax.tree.leaves(jscales)]
    # the trainer's in-place form: the same gradients and errors
    glist, elist = leaves(tree_from_jax(np_tree(jgrads))), leaves(tree_from_jax(np_tree(jerr)))
    tcomp.compress_in_place(glist, elist)
    for a, b in zip(glist + elist, jax.tree.leaves(jdeq) + jax.tree.leaves(jerr2)):
        np.testing.assert_array_equal(f32(a), f32(b))
    # the explicit all-reduce over a 1-wide data axis is the dequantisation
    # (tests/test_torch_distributed.py holds it to the reference)
    from repro_torch.launch.mesh import make_local_mesh
    mesh = make_local_mesh(1, 1, device="cpu")
    for q, s in zip(leaves(qs), leaves(scales)):
        assert torch.equal(tcomp.ef_allreduce(mesh, ("data",), q, s), q.float() * s)


def test_router_aux_loss_against_reference():
    jcfg = jget("mixtral-8x7b")
    rng = np.random.default_rng(4)
    router = rng.standard_normal((jcfg.d_model, jcfg.moe.n_experts)).astype(np.float32)
    x = rng.standard_normal((3, 10, jcfg.d_model)).astype(np.float32)
    x[0, 0] = 0.0                                  # a row of tied router logits
    want = JMOE.router_aux_loss({"router": jnp.asarray(router)}, jnp.asarray(x), jcfg.moe)
    got = TMOE.router_aux_loss({"router": torch.from_numpy(router)}, torch.from_numpy(x),
                               get_reduced("mixtral-8x7b").moe)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


# ------------------------------------------------------------- data
@pytest.mark.parametrize("case", ["synthetic", "shards", "corpus"])
def test_pipeline_batches_equal_bitwise(case):
    kw = dict(vocab_size=5000, seq_len=32, global_batch=8, seed=3)
    docs = ["first document text", "second one", "third piece of text here"]
    if case == "corpus":
        kw.update(vocab_size=300, seq_len=16, backend="corpus")
    shards = [(4, i) for i in range(4)] if case == "shards" else [(1, 0)]
    for n, i in shards:
        extra = dict(corpus=docs) if case == "corpus" else {}
        a = DataPipeline(DataConfig(**kw), n_shards=n, shard_id=i, **extra)
        b = JPipeline(JDataConfig(**kw), n_shards=n, shard_id=i, **extra)
        for step in (0, 1, 17):
            x, y = a.batch(step)["tokens"], b.batch(step)["tokens"]
            assert x.dtype == y.dtype and x.shape == y.shape and x.tobytes() == y.tobytes()


# --------------------------------------------------------------- checkpoint
def _state_pair(arch="minicpm-2b"):
    """The same fp32 training state in both packages: parameters, moments
    after one step, and an error state."""
    params, _, _, _, jgrads_flat = reference(arch)
    jcfg = dataclasses.replace(jget(arch), dtype="float32")
    jgrads = jax.tree.unflatten(jax.tree.structure(params), jgrads_flat)
    p1, opt, _ = jopt.apply_updates(params, jgrads, jopt.init_opt_state(params),
                                    jopt.OptimConfig())
    jstate = {"params": p1, "opt": opt, "err": jcomp.init_error_state(p1)}
    lm = from_jax_params(np_tree(p1), dataclasses.replace(get_reduced(arch),
                                                          dtype="float32"), device="cpu")
    assert jcfg.tie_embeddings == ("lm_head" not in p1)
    # the encoder's parameters sort between embed and final_norm on both sides
    assert bool(jcfg.enc_pattern) == ("enc_stacks" in lm.param_tree())
    tstate = {"params": lm.param_tree(), "opt": opt_state_from_jax(np_tree(opt)),
              "err": tree_from_jax(np_tree(jstate["err"]))}
    return jstate, tstate


def _bf16_pair():
    """A bf16 tree of the reference's layout in both packages."""
    rng = np.random.default_rng(5)
    j = {"b": jnp.asarray(rng.standard_normal((3, 4)), jnp.bfloat16),
         "a": [jnp.arange(5, dtype=jnp.int32), jnp.asarray(rng.standard_normal(2), jnp.float32)]}
    return j, tree_from_jax(np_tree(j))


@pytest.mark.parametrize("which", ["fp32_state", "bf16", "encdec_state"])
def test_checkpoint_files_equal_and_restore_across_packages(which, tmp_path):
    jtree, ttree = {"fp32_state": _state_pair, "bf16": _bf16_pair,
                    "encdec_state": lambda: _state_pair("seamless-m4t-medium")}[which]()
    jdir, tdir = str(tmp_path / "jax"), str(tmp_path / "torch")
    jckpt.save(jdir, 7, jtree, extra={"note": "x"})
    tckpt.save(tdir, 7, ttree, extra={"note": "x"})
    jm = json.load(open(os.path.join(jdir, "step_7", "manifest.json")))
    tm = json.load(open(os.path.join(tdir, "step_7", "manifest.json")))
    jm.pop("time"), tm.pop("time")
    assert tm == jm
    files = [m["file"] for m in tm["leaves"]]
    match, mismatch, errors = filecmp.cmpfiles(os.path.join(jdir, "step_7"),
                                               os.path.join(tdir, "step_7"), files,
                                               shallow=False)
    assert not mismatch and not errors and len(match) == len(files)
    # the reference's checkpoint restores in the port, the port's in the reference
    got, manifest = tckpt.restore(jdir, 7, ttree)
    assert manifest["step"] == 7 and manifest["extra"] == {"note": "x"}
    for a, b in zip(leaves(got), leaves(ttree)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    back, _ = jckpt.restore(tdir, 7, jtree)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(jtree)):
        assert a.dtype == b.dtype and (np.asarray(a) == np.asarray(b)).all()
    assert tckpt.latest_step(tdir) == jckpt.latest_step(jdir) == 7


def test_bf16_conversion_of_trees_is_bit_exact():
    jtree, ttree = _bf16_pair()
    assert ttree["b"].dtype == torch.bfloat16
    assert (ttree["b"].view(torch.int16).numpy().view(np.uint16)
            == np.asarray(jtree["b"]).view(np.uint16)).all()
    assert torch.equal(ttree["a"][0], to_tensor(np.arange(5, dtype=np.int32)))
