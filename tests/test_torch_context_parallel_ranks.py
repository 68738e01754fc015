"""Context-parallel decode caches on gloo ranks: one spawn a mesh shape
(2x1, 1x2, 2x2, all three running while the reference computes), every
arch of ``torch_dist_ranks.CP_ARCHS`` and a bf16 stablelm in each
(``cp_case``):

* batch 1 in the feature layout at 2x1 and 2x2: every KV cache's sequence
  cut over ``data`` (at 2x2 each process attends its span's heads);
* batch 2 under ``cache_layout="seq"`` at 1x2 and 2x2: rows over ``data``,
  the sequence over ``model``, every process attending every head over its
  slots;
* a 20-token prefill with 28 reserved slots, then 12 decode steps: the
  second half of the full-attention caches starts empty, the 16-slot rings
  wrap within the prefill and across their slices' boundary while decoding.

Logits of every call match the unsharded port's at rtol / atol 1e-5 in fp32
and the reference's ``LM.prefill`` / ``LM.decode_step`` at 1e-4; bf16 within
``TP_PSUM_RTOL`` / ``TP_PSUM_ATOL``.  At 2x1 each process's caches after the
prefill are the unsharded caches' slots, bitwise; after decoding their
positions are, and their first layer's K / V.
"""
from __future__ import annotations

import dataclasses
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import torch_dist_ranks as R
from repro.configs import get_reduced as jreduced
from repro.models import LM as JLM
from repro_torch.serving.engine import TP_PSUM_ATOL, TP_PSUM_RTOL

MESHES = ((2, 1), (1, 2), (2, 2))
IDS = {m: "x".join(map(str, m)) for m in MESHES}
CASES = [(m, layout) for m in MESHES for layout, _ in R.cp_layouts(*m)]
ARCHS = tuple(R.CP_ARCHS)
FP32 = 1e-5
REF = 1e-4


def jcfg(arch):
    return dataclasses.replace(jreduced(arch), dtype="float32", **R.CP_ARCHS[arch])


def jrun(jlm, params, batch):
    """The reference's logits of the prefill and every decode step (jitted:
    eager JAX takes minutes over the five archs)."""
    pre, steps = R.cp_inputs(jlm.cfg, batch)
    prefill = jax.jit(jlm.prefill, static_argnames=("reserve",))
    decode = jax.jit(jlm.decode_step)
    logits, caches = prefill(params, {k: jnp.asarray(v) for k, v in pre.items()},
                             reserve=R.CP_RESERVE)
    out = [np.asarray(logits)]
    for i, step in enumerate(steps):
        logits, caches = decode(params, caches, jnp.asarray(step), jnp.int32(R.CP_PROMPT + i))
        out.append(np.asarray(logits))
    return out


@pytest.fixture(scope="module")
def cp(tmp_path_factory):
    wdir = tmp_path_factory.mktemp("weights")
    models, weights = {}, {}
    for arch in ARCHS:
        jlm = JLM(jcfg(arch))
        host = jax.tree.map(np.asarray, jlm.init(jax.random.PRNGKey(0)))
        weights[arch] = str(wdir / f"{arch}.pkl")
        with open(weights[arch], "wb") as f:
            pickle.dump(host, f)
        models[arch] = (jlm, host)
    jobs = {m: R.start_ranks("cp_case", m[0] * m[1], tmp_path_factory.mktemp("cp"),
                             *m, weights) for m in MESHES}
    ref = {}
    for arch, (jlm, host) in models.items():
        params = jax.tree.map(jnp.asarray, host)
        for batch in (1, 2):
            ref[arch, batch] = jrun(jlm, params, batch)
    out = {m: R.join_ranks(job, timeout=400.0) for m, job in jobs.items()}
    return ref, out


def case_ids(c):
    return f"{IDS[c[0]]}-{c[1]}"


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("case", CASES, ids=case_ids)
def test_cp_logits_fp32_match_unsharded_and_reference(cp, case, arch):
    ref, out = cp
    mesh, layout = case
    batch = dict(R.cp_layouts(*mesh))[layout]
    for res in out[mesh]:
        r = res[arch, layout]
        lo, hi = r["rows"]
        base, got = r["base"][0], r["got"][0]
        assert len(got) == len(base) == R.CP_STEPS + 1
        for g, b, j in zip(got, base, ref[arch, batch]):
            np.testing.assert_allclose(g, b[lo:hi], rtol=FP32, atol=FP32)
            np.testing.assert_allclose(g, j[lo:hi], rtol=REF, atol=REF)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("case", CASES, ids=case_ids)
def test_cp_caches_are_cut_where_the_layout_says(cp, case, arch):
    """Every KV cache (``xdec``'s cross pair too) is cut, over ``data`` in
    the feature layout and over ``model`` under ``seq``, into two slices
    indexed by the process's coordinate; recurrent states are not."""
    mesh, layout = case
    axis = "data" if layout == "feature" else "model"
    for rank, res in enumerate(cp[1][mesh]):
        coord = (rank // mesh[1]) if axis == "data" else (rank % mesh[1])
        for stack in res[arch, layout]["cuts"]:
            kv = [c for c in stack if c is not None]
            assert kv and len(stack) - len(kv) == (1 if arch == "hymba-1.5b" else 0)
            for c in kv:
                assert (c.axes, c.parts, c.index) == ((axis,), 2, coord)


@pytest.mark.parametrize("case", CASES, ids=case_ids)
def test_cp_logits_bf16_within_psum_tolerance(cp, case):
    mesh, layout = case
    for res in cp[1][mesh]:
        r = res["stablelm-bf16", layout]
        lo, hi = r["rows"]
        for g, b in zip(r["got"][0], r["base"][0]):
            assert np.isfinite(g).all()
            np.testing.assert_allclose(g, b[lo:hi], rtol=TP_PSUM_RTOL, atol=TP_PSUM_ATOL)


def _kv(c):
    """(k, v, pos) of a host cache entry's KV part (a stack's cache, or its
    first element for Hymba / ``xdec``)."""
    return c if hasattr(c, "_fields") else c[0]


@pytest.mark.parametrize("arch", ARCHS + ("stablelm-bf16",))
def test_cp_2x1_slices_are_the_unsharded_slots(cp, arch):
    """At 2x1 (batch 1, feature layout) process r holds slots ``[r n,
    (r + 1) n)`` of every unsharded cache: bitwise after the prefill (and
    ``xdec``'s cross pair); after 12 decode steps the positions bitwise, the
    first layer's K / V bitwise, every K / V within 1e-5 (bf16: its
    tolerance)."""
    tol = (dict(rtol=FP32, atol=FP32) if arch != "stablelm-bf16"
           else dict(rtol=TP_PSUM_RTOL, atol=TP_PSUM_ATOL))
    for rank, res in enumerate(cp[1][(2, 1)]):
        r = res[arch, "feature"]
        base_pre, base_end = r["base"][1], r["base"][2]
        got_pre, got_end = r["got"][1], r["got"][2]
        for stack in range(len(base_pre)):
            bp, gp = base_pre[stack], got_pre[stack]
            pairs = [(_kv(bp), _kv(gp))]
            if arch == "seamless-m4t-medium":
                pairs.append(((bp[1], bp[2]), gp[1]))     # the cross pair
            for whole, part in pairs:
                n = part[0].shape[2]
                for w, p in zip(whole[:2], part[:2]):
                    np.testing.assert_array_equal(p, w[:, :, rank * n:(rank + 1) * n])
            be, ge = _kv(base_end[stack]), _kv(got_end[stack])
            n = ge.k.shape[2]
            np.testing.assert_array_equal(ge.pos, be.pos[:, rank * n:(rank + 1) * n])
            for w, p in zip(be[:2], ge[:2]):
                if stack == 0:
                    np.testing.assert_array_equal(p[0], w[0][:, rank * n:(rank + 1) * n])
                np.testing.assert_allclose(p, w[:, :, rank * n:(rank + 1) * n], **tol)
        # the second half of the full-attention slots starts empty, then fills
        if arch not in ("mixtral-8x7b",):
            pos = _kv(got_pre[0]).pos[0]
            assert (pos[:R.CP_PROMPT] >= 0).all() if rank == 0 else (pos < 0).all()
            assert (_kv(got_end[0]).pos[0] >= 0).any()
