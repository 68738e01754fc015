"""``Trainer(mesh=, plan=)`` on reduced mixtral-8x7b, and at 1x1 on both
families.

* In spawned gloo ranks (``torch_dist_ranks.train_case``), fp32 at d_model
  1152, two steps from the reference's weights against the reference's
  unsharded ``Trainer`` (``torch_train_ref``'s tolerances): 2x1 zero1 and
  the int8 run, 1x2 fsdp and the int8 run, 2x2 zero1 and fsdp.  The batch's
  rows are split over data after the microbatch is taken, and MoE capacity
  is ranked over the microbatch's rows, as in the reference.
* 1x1, in process: bitwise equal to the port's unsharded ``Trainer``
  (losses, gradient norms, every parameter, moment and error entry) for
  zero1, fsdp and the int8 run of reduced llama3-8b and mixtral-8x7b in
  their own bf16, and the checkpoint files byte-equal.
"""
from __future__ import annotations

import filecmp
import json
import os

import numpy as np
import pytest
import torch

import torch_dist_ranks as R
import torch_train_ref as T
from repro_torch.configs import get_reduced
from repro_torch.distributed import ShardingPlan
from repro_torch.launch.mesh import make_local_mesh
from repro_torch.models import LM
from repro_torch.training import OptimConfig, TrainConfig, Trainer
from repro_torch.training.tree import leaves

ARCH = "mixtral-8x7b"
ZERO1, FSDP, INT8 = (ARCH, {}, 1, False), (ARCH, {"fsdp": True}, 1, False), (ARCH, {}, 2, True)
RUNS = {(2, 1): (ZERO1, INT8), (1, 2): (FSDP, INT8), (2, 2): (ZERO1, FSDP)}
ONE_BY_ONE = tuple((arch, plan, a, c) for arch in ("llama3-8b", ARCH)
                   for plan, a, c in (({}, 1, False), ({"fsdp": True}, 1, False), ({}, 2, True)))


def run_id(x):
    if isinstance(x[0], int):
        return "x".join(map(str, x))
    return f"{x[0]}-{'fsdp' if x[1] else 'zero1'}-a{x[2]}-c{int(x[3])}"


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The reference's runs and every mesh's rank results, the ranks
    running while the reference computes."""
    path = str(tmp_path_factory.mktemp("weights") / f"{ARCH}.pkl")
    jlm, host = T.jmodel(ARCH, path)
    bs = T.batches()[:2]
    jobs = {shape: R.start_ranks("train_case", shape[0] * shape[1],
                                 tmp_path_factory.mktemp("train"), *shape, runs,
                                 {ARCH: path}, bs)
            for shape, runs in RUNS.items()}
    ref = {(1, False): T.jrun(jlm, host, bs, 1, False), (2, True): T.jrun(jlm, host, bs, 2, True)}
    return ref, {shape: R.join_ranks(job, timeout=300.0) for shape, job in jobs.items()}


@pytest.mark.parametrize("shape,run", [(s, r) for s, runs in RUNS.items() for r in runs],
                         ids=run_id)
def test_sharded_moe_training_matches_reference(shape, run, runs):
    hist, snaps = runs[0][(run[2], run[3])]
    got = runs[1][shape][0][(run[0], tuple(run[1].items()), run[2], run[3])]
    # int8: held for its first step.  An entry that rounds to the other int8
    # level moves up to lr (1e-3) from the reference's; at the second step
    # such a router entry can move a token's top-2 experts, a discrete
    # change of the loss (2x1 held both steps, 1x2 moved its second loss by
    # 4.5e-4).  Two int8 steps are held on llama (continuous) at 2x1 and 1x2.
    T.check_run(got, (hist, snaps), run[3], steps=1 if run[3] else 2)
    assert all(np.isfinite(h).all() for h in got[0])


# ------------------------------------------------------------ 1x1 in process
@pytest.fixture(scope="module")
def mesh11():
    return make_local_mesh(1, 1, device="cpu")


def port_run(arch, plan, a, c, mesh, ckpt_dir):
    cfg = get_reduced(arch)
    lm = LM(cfg, device="cpu", generator=torch.Generator().manual_seed(0))
    tc = TrainConfig(steps=2, log_every=0, grad_accum=a, compression=c, ckpt_dir=ckpt_dir,
                     ckpt_async=False, optim=OptimConfig(**R.TRAIN_OPTIM))
    tr = Trainer(lm, tc, mesh=mesh, plan=ShardingPlan(**plan) if mesh is not None else None)
    state = tr.init_state()
    rng = np.random.default_rng(3)
    bs = [{"tokens": torch.from_numpy(rng.integers(0, cfg.vocab_size, (4, 16))
                                      .astype(np.int32))} for _ in range(2)]
    hist = tr.run(state, iter(bs), resume=False)["history"]
    return [(r["loss"], r["grad_norm"]) for r in hist], leaves(state)


@pytest.mark.parametrize("run", ONE_BY_ONE, ids=run_id)
def test_mesh_1x1_trainer_bitwise_and_checkpoint_bytes(run, mesh11, tmp_path):
    hist, state = port_run(*run, None, str(tmp_path / "plain"))
    shist, sstate = port_run(*run, mesh11, str(tmp_path / "sharded"))
    assert shist == hist
    assert len(sstate) == len(state)
    assert all(torch.equal(x, y) for x, y in zip(sstate, state))
    a_dir, b_dir = tmp_path / "plain" / "step_2", tmp_path / "sharded" / "step_2"
    files = sorted(os.listdir(a_dir / "host_0"))
    assert files and files == sorted(os.listdir(b_dir / "host_0"))
    match, mismatch, errors = filecmp.cmpfiles(a_dir / "host_0", b_dir / "host_0", files,
                                               shallow=False)
    assert not mismatch and not errors and match == files
    ma, mb = (json.loads((d / "manifest.json").read_text()) for d in (a_dir, b_dir))
    assert ma["leaves"] == mb["leaves"] and ma["step"] == mb["step"] == 2
