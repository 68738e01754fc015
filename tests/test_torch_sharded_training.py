"""``Trainer(mesh=, plan=)`` on reduced llama3-8b: the port's sharded
training state against the reference's unsharded ``Trainer``.

In spawned gloo ranks (``torch_dist_ranks.train_case``), fp32 at d_model
1152 (so that ``zero1_specs`` cuts moments over the data axes), two steps
from the reference's weights on the same batches (``torch_train_ref``'s
tolerances: losses and gradient norms rtol 1e-5, parameters atol 1e-5, the
int8 runs' rare rounding flips bounded apart):

* 2x1: zero1, fsdp, two microbatches with int8 error feedback;
* 1x2: zero1, the int8 run; the 2x1 zero1 run's step-2 checkpoint (moments
  cut over data) resumes here (cut over model) and takes the reference's
  step 3; and the gradient test below;
* 2x2: fsdp.

The gradient test: ``stacks/0/wo`` (H*hd, D) is cut over ``model`` on its
input dim and its product summed over ``model``.  The gradient
``torch.autograd.grad`` gives it under the shard context is twice the
reference's slice: ``_AllReduce.backward`` sums over the group, exact for
the sum of both processes' losses, which is twice the loss they share.  The
trainer's reduction divides it back.
"""
from __future__ import annotations

import numpy as np
import pytest

import torch_dist_ranks as R
import torch_train_ref as T

ARCH = "llama3-8b"
ZERO1, FSDP, INT8 = (ARCH, {}, 1, False), (ARCH, {"fsdp": True}, 1, False), (ARCH, {}, 2, True)
RUNS = {(2, 1): (ZERO1, FSDP, INT8), (1, 2): (ZERO1, INT8), (2, 2): (FSDP,)}


def key(run):
    arch, plan, a, c = run
    return (arch, tuple(plan.items()), a, c)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The reference's runs and every mesh's rank results.  The ranks of
    2x1 and 2x2 run while the reference computes; 1x2 resumes the
    checkpoint 2x1 wrote."""
    path = str(tmp_path_factory.mktemp("weights") / f"{ARCH}.pkl")
    jlm, host = T.jmodel(ARCH, path)
    weights, bs = {ARCH: path}, T.batches()
    ckpt_dir = str(tmp_path_factory.mktemp("ckpt_2x1"))

    def start(shape, *extra):
        return R.start_ranks("train_case", shape[0] * shape[1],
                             tmp_path_factory.mktemp("train"), *shape, RUNS[shape],
                             weights, bs, *extra)

    first = {(2, 1): start((2, 1), ckpt_dir), (2, 2): start((2, 2))}
    ref = {(1, False): T.jrun(jlm, host, bs, 1, False),
           (2, True): T.jrun(jlm, host, bs[:2], 2, True)}
    grad = jax_grad_wo(jlm, host, bs[0])
    out = {(2, 1): R.join_ranks(first[(2, 1)], timeout=300.0)}
    resume = start((1, 2), None, ckpt_dir, True)
    out[(2, 2)] = R.join_ranks(first[(2, 2)], timeout=300.0)
    out[(1, 2)] = R.join_ranks(resume, timeout=300.0)
    return ref, grad, out


def jax_grad_wo(jlm, host, batch):
    import jax
    import jax.numpy as jnp
    params = jax.tree.map(jnp.asarray, host)
    g = jax.grad(lambda p: jlm.loss(p, jax.tree.map(jnp.asarray, batch))[0])(params)
    return np.asarray(g["stacks"][0]["wo"])


@pytest.mark.parametrize("shape,run", [(s, r) for s, runs in RUNS.items() for r in runs],
                         ids=lambda x: "x".join(map(str, x)) if isinstance(x[0], int)
                         else f"{x[0]}-{'fsdp' if x[1] else 'zero1'}-a{x[2]}-c{int(x[3])}")
def test_sharded_training_matches_reference(shape, run, runs):
    hist, snaps = runs[0][(run[2], run[3])]
    T.check_run(runs[2][shape][0][key(run)], (hist, snaps), run[3])


def test_checkpoint_2x1_restores_at_1x2(runs):
    hist, snaps = runs[0][(1, False)]
    steps, params = runs[2][(1, 2)][0]["resumed"]
    assert [s[0] for s in steps] == [3]
    T.check_run(([s[1:] for s in steps], [params]), (hist[2:], snaps[2:]), False, steps=1)


def test_gradient_1x2_model_sum_backward(runs):
    grad = runs[1]
    half = grad.shape[1] // 2
    for r, out in enumerate(runs[2][(1, 2)]):
        raw, reduced, spec = out["grads"]
        assert spec[1] == "model"
        want = grad[:, r * half:(r + 1) * half]
        np.testing.assert_allclose(raw, 2 * want, rtol=1e-4, atol=1e-6)
        np.testing.assert_allclose(reduced, want, rtol=1e-4, atol=1e-6)
        # the factor is the model size, not noise: the largest entries agree
        big = np.abs(want) > 1e-3
        assert np.allclose(raw[big] / want[big], 2.0, rtol=1e-3)
