"""The reference's side of the sharded-training tests
(``tests/test_torch_sharded_*training.py``): its weights for the ranks, its
unsharded ``Trainer`` step by step, and the comparisons.  No ``test_``
prefix: pytest does not collect it."""
from __future__ import annotations

import dataclasses
import pickle

import jax
import jax.numpy as jnp
import numpy as np

import torch_dist_ranks as R
from repro.configs import get_reduced as jreduced
from repro.models.model import LM as JLM
from repro.training.compression import init_error_state as jinit_err
from repro.training.optimizer import OptimConfig as JOptim
from repro.training.optimizer import init_opt_state as jinit_opt
from repro.training.train_loop import TrainConfig as JTrainConfig
from repro.training.train_loop import Trainer as JTrainer

RTOL = 1e-5          # losses and gradient norms against the reference
PARAM_ATOL = 1e-5    # every parameter after two AdamW steps at lr 1e-3
# int8 runs: the reduced gradient is summed in another order than the
# reference's, so an element whose quotient by the scale sits within
# rounding of a half step rounds to the other int8 level, and its error
# feedback carries the difference into the next step; through AdamW's
# normalised update such an element moves by up to lr a step more or less.
# The losses and norms of a dense model stay within RTOL.
# They may be at most INT8_FLIPS of a leaf (the most seen: 13 of the 9216
# router entries of mixtral at 2x1, 1.4e-3), each within two steps of lr.
INT8_FLIPS = 2e-3
INT8_PARAM_ATOL = 2e-3


def batches():
    rng = np.random.default_rng(7)
    return [{"tokens": rng.integers(0, 512, (4, 16)).astype(np.int32)} for _ in range(3)]


def jkey(path) -> str:
    return "/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path)


def jflat(tree) -> dict:
    return {jkey(p): np.asarray(x) for p, x in jax.tree_util.tree_flatten_with_path(tree)[0]}


def jmodel(arch, path):
    """The reference's wide fp32 model (``torch_dist_ranks.wide``), its
    parameters pickled to ``path`` for the ranks."""
    jlm = JLM(dataclasses.replace(jreduced(arch), dtype="float32", d_model=1152))
    params = jlm.init(jax.random.PRNGKey(0))
    host = jax.tree.map(np.asarray, params)
    with open(path, "wb") as f:
        pickle.dump(host, f)
    return jlm, host


def jrun(jlm, host, bs, a, c):
    """The reference's unsharded ``Trainer`` step by step over ``bs``: the
    (loss, grad norm) and the parameters after each step."""
    tr = JTrainer(jlm, JTrainConfig(steps=len(bs), log_every=0, grad_accum=a,
                                    compression=c, optim=JOptim(**R.TRAIN_OPTIM)))
    params = jax.tree.map(jnp.asarray, host)
    state = {"params": params, "opt": jinit_opt(params)}
    if c:
        state["err"] = jinit_err(params)
    hist, snaps = [], []
    for b in bs:
        state, m = tr._step_fn(state, jax.tree.map(jnp.asarray, b))
        hist.append((float(m["loss"]), float(m["grad_norm"])))
        snaps.append(jflat(state["params"]))
    return hist, snaps


def check_run(got, want, compressed: bool, steps: int = 2) -> None:
    """A rank's (history, gathered parameters after each step) against the
    reference's, over the first ``steps`` steps."""
    hist, snaps = got
    ref_hist, ref_snaps = want
    np.testing.assert_allclose(np.array(hist[:steps]), np.array(ref_hist[:steps]),
                               rtol=RTOL, atol=0)
    for params, ref_params in zip(snaps[:steps], ref_snaps[:steps]):
        assert set(params) == set(ref_params)
        for k, ref in ref_params.items():
            diff = np.abs(params[k] - ref)
            if compressed:
                assert float((diff > PARAM_ATOL).mean()) <= INT8_FLIPS, \
                    (k, int((diff > PARAM_ATOL).sum()))
                assert float(diff.max()) <= INT8_PARAM_ATOL, (k, float(diff.max()))
            else:
                assert float(diff.max()) <= PARAM_ATOL, (k, float(diff.max()))
