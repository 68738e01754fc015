"""repro_torch's SSM scan and MoE gating kernels on the CPU: the plans their
CUDA launchers take from the host (``ssm_plan``, ``gating_plan``), the SSM
kernel's arithmetic (``ssm_scan_exp2_plain``: the decay as an exp2 of a
pre-scaled a, y summed lane by lane) against the reference's Pallas kernel
in interpret mode, and a numpy model of the gating kernel's rank arithmetic
(ballot counts within a warp's rounds, warp offsets from one scan, block
offsets from the grid route's second launch) against ``moe_gating_plain``
and the Pallas kernel.

Tolerances: the SSM 1e-4 in fp32 (the reference's own); gating ids and
ranks exact."""
import pathlib
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.moe_gating import moe_gating as pallas_gating
from repro.kernels.ssm_scan import ssm_scan as pallas_ssm
from repro_torch.kernels import moe_gating as mg, ssm_scan as ss

CSRC = pathlib.Path(__file__).resolve().parents[1] / "src" / "repro_torch" / "kernels" / "csrc"
# (b, s, d, n): chip_smoke.py's SSM sweep (test_ssm_scan's shapes, every
# built state size, a ragged D), one chunk of S and one block of D each
SSM_SWEEP = [(2, 128, 64, 16), (1, 64, 128, 8), (1, 48, 200, 4), (2, 40, 96, 32),
             (1, 33, 130, 64)]
LIMIT = mg.one_launch_limit(8, 2)
BLOCK = mg.GRID_WARPS * 32  # tokens a block takes while a cluster is not full


def ident(shape):
    return "-".join(map(str, shape))


def ssm_inputs(seed, b, s, d, n):
    """As test_ssm_scan: dt a small positive softplus, a negative."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, s, d)).astype(np.float32)
    dt = (np.log1p(np.exp(rng.standard_normal((b, s, d)))) * 0.2).astype(np.float32)
    bt = rng.standard_normal((b, s, n)).astype(np.float32)
    ct = rng.standard_normal((b, s, n)).astype(np.float32)
    a = -np.abs(rng.standard_normal((d, n))).astype(np.float32)
    return x, dt, bt, ct, a


def pallas_y(arrs):
    s, d = arrs[0].shape[1:]
    return np.asarray(pallas_ssm(*map(jnp.asarray, arrs), block_d=d, chunk=s, interpret=True))


# --------------------------------------------------------------------- ssm
@pytest.mark.parametrize("d", [1, 130, 200, 1600, 1601])
@pytest.mark.parametrize("n", ss.SUPPORTED_STATES)
def test_ssm_plan_covers_every_channel_and_state_once(n, d):
    """Every (channel, state) belongs to exactly one thread; a channel's
    lanes are adjacent and aligned in one warp (the shuffles add over them);
    no block is wholly past D."""
    plan = ss.ssm_plan(d, n)
    assert plan.lanes * plan.states == n and 32 % plan.lanes == 0
    assert plan.channels * plan.lanes == ss.THREADS
    assert (plan.blocks - 1) * plan.channels < d <= plan.blocks * plan.channels
    seen = np.zeros((plan.blocks * plan.channels, n), dtype=int)
    for block in range(plan.blocks):
        for tid in range(ss.THREADS):
            ch, states = plan.owner(block, tid)
            seen[ch, states] += 1
            first = tid - tid % plan.lanes
            assert plan.owner(block, first)[0] == ch and first // 32 == tid // 32
    assert (seen == 1).all()


@pytest.mark.parametrize("shape", SSM_SWEEP, ids=ident)
def test_ssm_exp2_recurrence_matches_the_pallas_kernel(shape):
    arrs = ssm_inputs(40, *shape)
    got = ss.ssm_scan_exp2_plain(*map(torch.from_numpy, arrs)).numpy()
    np.testing.assert_allclose(got, pallas_y(arrs), atol=1e-4, rtol=0)


@pytest.mark.parametrize("kind", ["flush", "a_zero", "x_zero"])
def test_ssm_exp2_recurrence_at_the_edges(kind):
    """Decays that all flush to 0 (dt * a log2 e under -126: ex2.approx.ftz
    gives 0 where exp gives a subnormal or 0), a = 0 (every decay exactly 1),
    a whole sequence of x = 0 (y exactly 0): against the Pallas kernel and
    the plain recurrence."""
    x, dt, bt, ct, a = ssm_inputs(41, 2, 64, 128, 16)
    if kind == "flush":
        dt = (dt + 1.0).astype(np.float32)
        a = (a - 100.0).astype(np.float32)
        assert (dt[..., None] * (a * np.float32(ss.LOG2E)) < -126).all()
    elif kind == "a_zero":
        a = np.zeros_like(a)
    else:
        x[0] = 0.0
    arrs = (x, dt, bt, ct, a)
    targs = list(map(torch.from_numpy, arrs))
    got = ss.ssm_scan_exp2_plain(*targs).numpy()
    np.testing.assert_allclose(got, pallas_y(arrs), atol=1e-4, rtol=0)
    np.testing.assert_allclose(got, ss.ssm_scan_plain(*targs).numpy(), atol=1e-4, rtol=0)
    if kind == "x_zero":
        assert not got[0].any()


def test_ssm_kernel_constants_match_the_plan():
    """The CUDA source is built with the plan's block size, staging depth and
    split, and the wrapper hands the plan's lanes to the launcher, which
    refuses any other."""
    src = (CSRC / "ssm_scan.cu").read_text()
    assert int(re.search(r"constexpr int kThreads = (\d+);", src).group(1)) == ss.THREADS
    assert int(re.search(r"constexpr int kSteps = (\d+);", src).group(1)) == ss.STEPS
    assert "kStates = N < 8 ? N : 8;" in src
    assert [ss.ssm_plan(1, n).states for n in ss.SUPPORTED_STATES] == [4, 8, 8, 8, 8]
    assert "if (lanes != P::kLanes) return -3;" in src
    assert "a.shape[1], plan.lanes," in (CSRC.parent / "ssm_scan.py").read_text()


# ------------------------------------------------------------------ gating
@pytest.mark.parametrize("t", [1, 31, 32, 33, BLOCK, BLOCK + 1, 2048, LIMIT - 1, LIMIT,
                               LIMIT + 1, 32768, 1 << 22])
def test_gating_plan_routes_at_and_past_the_one_launch_limit(t):
    """One block up to a block's tokens, a cluster of up to MAX_CLUSTER
    blocks (still one launch) up to the one-launch limit, a grid past it."""
    plan = mg.gating_plan(t, 8, 2)
    assert plan.route == ("one_block" if t <= BLOCK else "cluster" if t <= LIMIT else "grid")
    assert plan.rows_in_registers
    assert (plan.blocks - 1) * plan.span < t <= plan.blocks * plan.span
    assert 1 <= plan.warps <= mg.MAX_WARPS and 1 <= plan.rounds <= mg.max_rounds(2)
    if plan.route == "one_block":
        assert plan.blocks == 1 and plan.warps == -(-t // 32)
    elif plan.route == "cluster":
        assert 2 <= plan.blocks <= mg.MAX_CLUSTER
    else:
        assert plan.warps == mg.GRID_WARPS
        assert plan.blocks <= mg.GRID_BLOCKS or plan.rounds == mg.max_rounds(2)
    if t == 2048:  # Mixtral's 16 x 128 probe batch: a full cluster, one round
        assert plan == mg.GatingPlan("cluster", True, mg.GRID_WARPS, 1, mg.MAX_CLUSTER)


@pytest.mark.parametrize("e", [1, 4, 8, 16, 64, 256])
def test_gating_plan_for_every_k(e):
    """Every k and E the kernel takes gives a plan that fits a block's
    shared memory; only E 8 holds its rows in registers."""
    for k in range(1, min(e, mg.MAX_K) + 1):
        limit = mg.one_launch_limit(e, k)
        for t in (*range(1, 600, 7), limit - 1, limit, limit + 1, 5000, 40000):
            plan = mg.gating_plan(t, e, k)
            assert plan.rows_in_registers == (e == mg.ROW_EXPERTS)
            assert mg.smem_bytes(plan, e) <= mg.SMEM_BUDGET
            assert plan.rounds <= mg.max_rounds(k)
            assert (plan.blocks - 1) * plan.span < t <= plan.blocks * plan.span
            assert (plan.route == "grid") == (t > limit)
            assert plan.blocks <= mg.MAX_CLUSTER or plan.route == "grid"


def kernel_ranks(idx, e, plan):
    """The kernel's rank arithmetic in numpy, step for step: per block, warp
    and expert, a ballot a round of the lanes one of whose choices is the
    expert, a slot's rank the running count plus the popcount of the lanes
    below; each warp's total to the block's scan (exclusive over warps);
    each block's totals summed over the blocks before it (a cluster's
    blocks read them from each other's shared memory, the grid route's
    second launch from global memory)."""
    t_all, k = idx.shape
    pos = np.full((t_all, k), -1, dtype=np.int64)
    totals = np.zeros((plan.blocks, e), dtype=np.int64)
    lanes = np.arange(32)
    for b in range(plan.blocks):
        cnt = np.zeros((e, plan.warps), dtype=np.int64)
        rank = {}
        for w in range(plan.warps):
            first = b * plan.span + w * 32 * plan.rounds
            for ex in range(e):
                run = 0
                for r in range(plan.rounds):
                    toks = first + 32 * r + lanes
                    live = toks < t_all
                    hit = np.zeros(32, dtype=bool)
                    hit[live] = (idx[toks[live]] == ex).any(axis=1)
                    mask = int(np.sum(hit.astype(np.int64) << lanes))
                    for lane in np.flatnonzero(hit):
                        j = int(np.flatnonzero(idx[toks[lane]] == ex)[0])
                        rank[toks[lane], j] = run + bin(mask & ((1 << lane) - 1)).count("1")
                    run += bin(mask).count("1")
                cnt[ex, w] = run
        off = np.cumsum(cnt, axis=1) - cnt
        totals[b] = cnt.sum(axis=1)
        for (tok, j), rk in rank.items():
            w = (tok - b * plan.span) // (32 * plan.rounds)
            pos[tok, j] = off[idx[tok, j], w] + rk
    before = np.cumsum(totals, axis=0) - totals
    block = np.arange(t_all) // plan.span
    return pos + before[block[:, None], idx]


def adversarial_logits(kind, t, e, seed):
    rng = np.random.default_rng(seed)
    lg = rng.standard_normal((t, e)).astype(np.float32)
    if kind == "one_expert":          # every token's first choice is expert e - 1
        lg[:, -1] = 10.0
    elif kind == "tied":              # bf16-equal rows: every choice is 0, 1, ...
        lg[:] = 0.5
    elif kind == "blocks":            # the first half of the tokens on expert 0, the rest on 3
        lg[: t // 2, 0] = 9.0
        lg[t // 2:, 3 % e] = 9.0
    return lg


# (t, e, k, logits): random and adversarial ids; T 1, 31, 32, 33; one
# block's tokens and one past (the first cluster); the one-launch limit and
# one on either side; the grid route's block edges (blocks of 256 tokens at
# E 8: a last block of one token, of a whole block, of one short of it); a
# wide E on the staged rows, in a cluster and on the grid
RANK_CASES = [(2048, 8, 2, "random"), (1, 8, 2, "random"), (31, 8, 2, "random"),
              (32, 8, 2, "random"), (33, 8, 2, "random"), (BLOCK, 8, 2, "one_expert"),
              (BLOCK + 1, 8, 2, "random"), (LIMIT - 1, 8, 2, "random"),
              (LIMIT, 8, 2, "one_expert"), (LIMIT + 1, 8, 2, "random"),
              (LIMIT + 256, 8, 2, "blocks"), (LIMIT + 255, 8, 1, "one_expert"),
              (4097, 8, 2, "tied"), (700, 8, 8, "random"), (300, 1, 1, "random"),
              (200, 256, 8, "random"), (600, 256, 8, "random"), (600, 64, 4, "one_expert"),
              (100, 16, 3, "random")]


@pytest.mark.parametrize("case", RANK_CASES, ids=ident)
def test_gating_rank_model_matches_plain_and_pallas(case):
    t, e, k, kind = case
    lg = adversarial_logits(kind, t, e, 50 + t)
    plan = mg.gating_plan(t, e, k)
    idx = np.argsort(-lg, axis=1, kind="stable")[:, :k]  # the kernel's top k, ties low first
    got = kernel_ranks(idx, e, plan)
    p_idx, _, p_pos = mg.moe_gating_plain(torch.from_numpy(lg), k)
    assert (p_idx.numpy() == idx).all()
    assert (got == p_pos.numpy()).all()
    j_idx, _, j_pos = pallas_gating(jnp.asarray(lg), k, interpret=True)
    assert (np.asarray(j_idx) == idx).all() and (np.asarray(j_pos) == got).all()
    if kind in ("one_expert", "tied"):  # one expert takes every token's first slot
        assert (got[:, 0] == np.arange(t)).all()


def test_gating_kernel_constants_match_the_plan():
    """The CUDA source is built with the plan's limits, and the wrapper
    hands the whole plan to the launcher, which refuses one it cannot run."""
    src = (CSRC / "moe_gating.cu").read_text()
    assert int(re.search(r"constexpr int kMaxWarps = (\d+);", src).group(1)) == mg.MAX_WARPS
    assert int(re.search(r"constexpr int kRowExperts = (\d+);", src).group(1)) == mg.ROW_EXPERTS
    assert int(re.search(r"constexpr int kMaxCluster = (\d+);", src).group(1)) == mg.MAX_CLUSTER
    assert "return K <= 4 ? 2 : 1;" in src
    assert [mg.max_rounds(k) for k in range(1, 9)] == [2, 2, 2, 2, 1, 1, 1, 1]
    assert "rounds > max_rounds<K>()" in src
    wrapper = (CSRC.parent / "moe_gating.py").read_text()
    assert "int(plan.rows_in_registers), plan.warps,\n                plan.rounds, plan.blocks" \
        in wrapper
