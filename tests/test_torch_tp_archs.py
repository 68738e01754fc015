"""Tensor parallelism for the archs whose heads a model axis cuts inside a
head, Hymba's SSM, the xLSTM, the encoder-decoder and the VLM's embeddings,
against the unsharded port engine and the reference's unsharded engine and
``Trainer``.

One spawn of gloo ranks a mesh shape (1x2 and 2x2, both running while the
reference computes) covers every arch of ``torch_dist_ranks.TP_ARCHS``
(``tp_arch_case``):

* fp32, from the reference's weights, in a config whose model axis cuts
  inside a q head and inside a kv head (minicpm, qwen2-vl, hymba; inside a
  recurrent head for the xLSTM; seamless at an odd vocab): probe logits
  within 1e-4 of the unsharded engine and of the reference's, a
  ``generate`` equal token for token, and one ``Trainer(mesh=)`` step
  (at 2x2 under ``fsdp``, the new leaves cut over ``data`` too) against
  the reference's unsharded ``Trainer`` (losses and gradient norms rtol
  1e-5, parameters atol 1e-5, ``torch_train_ref``);
* bf16, the stock reduced config from a seed: probe logits within
  ``TP_PSUM_RTOL`` / ``TP_PSUM_ATOL`` of the unsharded engine;
* each process's parameters are the reference's ``param_specs`` cut;
* bf16 reduced Mixtral at 1x2: the rows whose probe logits drift past the
  serving tolerance are exactly those holding a token whose router top-k
  flips between the engines, at a router margin within the router logits'
  bf16 difference (a reordered bf16 sum flipping a discrete choice).
"""
from __future__ import annotations

import dataclasses
import pickle

import jax
import numpy as np
import pytest

import torch_dist_ranks as R
import torch_train_ref as T
from repro.configs import get_reduced as jreduced
from repro.distributed import sharding as JS
from repro.models import LM as JLM
from repro.serving import ServeEngine as JEngine
from repro_torch.serving.engine import TP_PSUM_ATOL, TP_PSUM_RTOL

MESHES = ((1, 2), (2, 2))
PLANS = {(1, 2): {}, (2, 2): {"fsdp": True}}
ARCHS = tuple(R.TP_ARCHS)
FP32 = 1e-4
IDS = {m: "x".join(map(str, m)) for m in MESHES}


def jcfg(arch):
    return dataclasses.replace(jreduced(arch), dtype="float32", **R.TP_ARCHS[arch])


@pytest.fixture(scope="module")
def tp(tmp_path_factory):
    """The reference's weights, engines' probe logits and one training step
    per arch, and every mesh's rank results."""
    wdir = tmp_path_factory.mktemp("weights")
    models, weights = {}, {}
    for arch in ARCHS:
        jlm = JLM(jcfg(arch))
        host = jax.tree.map(np.asarray, jlm.init(jax.random.PRNGKey(0)))
        weights[arch] = str(wdir / f"{arch}.pkl")
        with open(weights[arch], "wb") as f:
            pickle.dump(host, f)
        models[arch] = (jlm, host)
    jobs = {m: R.start_ranks("tp_arch_case", m[0] * m[1], tmp_path_factory.mktemp("tp"),
                             *m, weights, PLANS[m]) for m in MESHES}
    ref = {}
    for arch, (jlm, host) in models.items():
        params = jax.tree.map(jax.numpy.asarray, host)
        ref[arch, "probes"] = np.asarray(
            JEngine(jlm, params, max_new_tokens=8).submit_probes(R.PROBES))
        ref[arch, "train"] = T.jrun(jlm, host, [R.tp_batch(jlm.cfg)], 1, False)
        ref[arch, "specs"] = JS.param_specs(params, mesh_like((1, 2)))
        ref[arch, "shapes"] = params
    out = {m: R.join_ranks(job, timeout=400.0) for m, job in jobs.items()}
    return ref, out


def mesh_like(shape):
    from types import SimpleNamespace
    names = ("data", "model")
    return SimpleNamespace(axis_names=names, shape=dict(zip(names, shape)))


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("mesh", MESHES, ids=IDS.get)
def test_tp_probe_logits_fp32_match_unsharded_and_reference(tp, mesh, arch):
    ref, out = tp
    for res in out[mesh]:
        base, sharded = res[arch, "fp32"]
        np.testing.assert_allclose(sharded, base, rtol=FP32, atol=FP32)
        np.testing.assert_allclose(sharded, ref[arch, "probes"], rtol=FP32, atol=FP32)
        np.testing.assert_array_equal(sharded, out[mesh][0][arch, "fp32"][1])


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("mesh", MESHES, ids=IDS.get)
def test_tp_probe_logits_bf16_within_psum_tolerance(tp, mesh, arch):
    for res in tp[1][mesh]:
        base, sharded = res[arch, "bf16"]
        assert np.isfinite(sharded).all()
        np.testing.assert_allclose(sharded, base, rtol=TP_PSUM_RTOL, atol=TP_PSUM_ATOL)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("mesh", MESHES, ids=IDS.get)
def test_tp_generate_fp32_token_for_token(tp, mesh, arch):
    for res in tp[1][mesh]:
        base, sharded = res[arch, "generate"]
        assert sharded == base
        assert any(sharded)


@pytest.mark.parametrize("arch", ARCHS)
def test_tp_train_step_1x2_matches_reference(tp, arch):
    ref, out = tp
    T.check_run(out[(1, 2)][0][arch, "train"], ref[arch, "train"], False, steps=1)


@pytest.mark.parametrize("arch", ARCHS)
def test_tp_train_step_2x2_fsdp_matches_reference(tp, arch):
    ref, out = tp
    T.check_run(out[(2, 2)][0][arch, "train"], ref[arch, "train"], False, steps=1)


@pytest.mark.parametrize("arch", ARCHS)
def test_tp_local_shapes_are_the_reference_cut(tp, arch):
    """Each process's parameters at 1x2 are the reference's ``param_specs``
    cut of its tree, leaf by leaf."""
    ref, out = tp
    specs = {T.jkey(p): s for p, s in jax.tree_util.tree_flatten_with_path(
        ref[arch, "specs"], is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))[0]}
    shapes = {k: v.shape for k, v in T.jflat(ref[arch, "shapes"]).items()}
    for rank, res in enumerate(out[(1, 2)]):
        got = res[arch, "shapes"]
        assert set(got) == set(shapes)
        cut = []
        for key, shape in shapes.items():
            want = [n // 2 if e == "model" or e == ("model",) else n
                    for n, e in zip(shape, tuple(specs[key]) + (None,) * len(shape))]
            assert got[key] == tuple(want), (rank, key, got[key], want)
            cut.append(tuple(want) != shape)
        assert any(cut)


def test_bf16_mixtral_1x2_router_flip_explains_the_drift(tp):
    """The reduced bf16 Mixtral at 1x2 (capacity factor 4: no slot is ever
    dropped): the rows past ``TP_PSUM_ATOL`` are exactly the rows holding a
    token whose top-2 experts differ between the engines, and each such
    token's router margin (2nd minus 3rd logit) is below the largest bf16
    difference of its router logits between the engines."""
    (base_logits, base_calls), (tp_logits, tp_calls) = tp[1][(1, 2)][0]["mixtral-bf16"]
    assert len(base_calls) == len(tp_calls)
    rows, seq = base_logits.shape[0], base_calls[0][0].shape[0] // base_logits.shape[0]
    flipped_rows, margins = set(), []
    for (lb, eb), (lt, et) in zip(base_calls, tp_calls):
        flips = np.nonzero((np.sort(eb, 1) != np.sort(et, 1)).any(1))[0]
        top = np.sort(lb, 1)[:, ::-1]
        for t in flips:
            margin = top[t, 1] - top[t, 2]
            margins.append(margin)
            assert margin <= np.abs(lb[t] - lt[t]).max() * 2, (t, margin)
            flipped_rows.add(int(t) // seq)
    # the model-axis sums reorder bf16 additions: the router logits differ
    assert any(np.abs(lb - lt).max() > 0 for (lb, _), (lt, _) in zip(base_calls, tp_calls))
    err = np.abs(base_logits - tp_logits).max(axis=1)
    drifted = set(np.nonzero(err > TP_PSUM_ATOL)[0].tolist())
    assert drifted <= flipped_rows, (drifted, flipped_rows)
    assert rows > len(flipped_rows)
    # every row without a flipped token stays within the serving tolerance
    clean = [r for r in range(rows) if r not in flipped_rows]
    np.testing.assert_allclose(tp_logits[clean], base_logits[clean],
                               rtol=TP_PSUM_RTOL, atol=TP_PSUM_ATOL)
