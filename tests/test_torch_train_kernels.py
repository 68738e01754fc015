"""repro_torch top-k scores and Borda count: the port's entry points on CPU
tensors (the kernels' plain versions) against the reference's
``repro.kernels.ops`` (the Pallas kernels in interpret mode) and its oracles
in ``repro.kernels.ref``, over the sweeps of ``tests/test_kernels.py``; ties,
all ``-inf`` scores (the reference's padding quirk), ids past ``n_items``;
the Borda kernel's route plan and its grid route's arithmetic; the
wrappers' argument checks, which run before any launch; the bounds.

Tolerance: none.  Top-k values and indices and Borda points are exact (the
points are small integers in fp32)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops, ref as jref
from repro.kernels.borda_count import borda_count as pallas_borda
from repro.kernels.topk_scores import topk_scores as pallas_topk
from repro_torch.kernels import borda_count as bc, ops, topk_scores as tk

# (n, k, block_n): test_topk's sweep, then a tile that is not a power of two
# (k above the padded length) and a ragged last tile
TOPK_SWEEP = [(1000, 10, 256), (4096, 16, 1024), (77, 5, 64), (128, 1, 32),
              (3, 5, 1024), (1100, 7, 512)]
# (r, s, n): test_borda's sweep, then ids past n_items and a wide ballot
BORDA_SWEEP = [(6, 20, 20), (3, 10, 50), (9, 15, 130), (1, 5, 5), (4, 12, 8), (2, 64, 300)]


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Many small tensor ops: one intra-op thread, since the suite runs
    several workers on the machine's cores and oversubscribed threads spin."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def ident(shape):
    return "-".join(map(str, shape))


def scores_of(seed, n):
    return np.random.default_rng(seed).standard_normal(n).astype(np.float32)


def check_topk(scores, k, block_n):
    """The port against ``repro.kernels.ops.topk_scores`` (the Pallas kernel
    in interpret mode and lax.top_k), exactly."""
    vals, idx = ops.topk_scores(torch.from_numpy(scores), k, block_n=block_n)
    jv, ji = jops.topk_scores(jnp.asarray(scores), k, block_n=block_n)
    assert vals.dtype == torch.float32 and idx.dtype == torch.int32
    assert vals.shape == idx.shape == (k,)
    assert (idx.numpy() == np.asarray(ji)).all(), (idx.tolist(), np.asarray(ji).tolist())
    np.testing.assert_array_equal(vals.numpy(), np.asarray(jv))
    return vals, idx


# ------------------------------------------------------------------- top-k
@pytest.mark.parametrize("shape", TOPK_SWEEP, ids=ident)
def test_topk_equals_reference_kernel_and_oracle(shape):
    n, k, bn = shape
    sc = scores_of(n + k, n)
    vals, idx = check_topk(sc, k, bn)
    rv, ri = jref.topk_ref(jnp.asarray(sc), min(k, n))
    if k <= n:                             # distinct finite scores: the oracle too
        assert (idx.numpy() == np.asarray(ri)).all()
        np.testing.assert_array_equal(vals.numpy(), np.asarray(rv))
    # and the reference's own stage 1 through its Pallas kernel
    bv, bi = pallas_topk(jnp.asarray(sc), k, block_n=bn, interpret=True)
    assert np.asarray(bv).shape == (-(-n // tk.tile_size(n, k, bn)), k)


def test_topk_ties_go_to_the_lower_index():
    """Equal scores inside a tile (jnp.argmax's first index) and across
    tiles (lax.top_k's lower candidate position)."""
    sc = scores_of(5, 300)
    sc[[7, 40, 41, 130, 299]] = 4.0        # a five-way tie at the top, over three tiles
    sc[[3, 200]] = 3.5
    vals, idx = check_topk(sc, 6, 64)
    assert idx.tolist() == [7, 40, 41, 130, 299, 3]
    rounded = np.round(scores_of(6, 2000), 1)   # many ties everywhere
    check_topk(rounded, 32, 256)


@pytest.mark.parametrize("case", ["all_minus_inf", "some_minus_inf", "k_past_tile"])
def test_topk_padding_quirk_is_the_references(case):
    """Padded slots hold -3e38, which outranks -inf: the port gives what
    ``repro.kernels.ops`` gives, not what ``ref.topk_ref`` would."""
    if case == "all_minus_inf":
        sc = np.full(100, -np.inf, np.float32)
        vals, idx = check_topk(sc, 5, 64)
        assert idx.tolist() == [0, 0, 0, 0, 100]
        assert idx.tolist() != np.asarray(jref.topk_ref(jnp.asarray(sc), 5)[1]).tolist()
    elif case == "some_minus_inf":
        sc = scores_of(8, 90)
        sc[:80] = -np.inf
        check_topk(sc, 16, 32)
    else:
        check_topk(scores_of(9, 20), 40, 16)   # k above block_n: repeats of a masked slot


@pytest.mark.parametrize("case", ["one_nan", "whole_tile_nan", "nan_in_every_tile"])
def test_topk_nan_ranks_first(case):
    """NaN scores (a diverged model's) rank above every number, the lower
    index first, as ``jnp.argmax`` and ``lax.top_k`` order them; a tile of
    nothing but NaN still hands on its own slots."""
    sc = scores_of(12, 300)
    if case == "one_nan":
        sc[77] = np.nan
        vals, idx = check_topk(sc, 6, 64)
        assert idx[0] == 77 and np.isnan(vals[0].item())
    elif case == "whole_tile_nan":
        sc[64:128] = np.nan                # tile 1 of 64 slots, no padding in it
        sc[5] = np.nan
        vals, idx = check_topk(sc, 8, 64)
        assert idx.tolist() == [5, 64, 65, 66, 67, 68, 69, 70]
    else:
        sc[::50] = np.nan
        check_topk(sc, 10, 32)


def global_topk(scores, k):
    """The k largest scores of the whole vector by (value desc, index asc),
    a NaN above every number: what top-k means without tiles."""
    nan = np.isnan(scores)
    order = np.lexsort((np.arange(len(scores)), -np.where(nan, 0, scores), ~nan))[:k]
    return scores[order], order.astype(np.int32)


def above_neg_inf(scores):
    return int((np.isnan(scores) | (scores > tk.NEG_INF)).sum())


@pytest.mark.parametrize("block_n", [16, 64, 100, 1024])
@pytest.mark.parametrize("kind", ["distinct", "ties", "mostly_minus_inf", "nan"])
def test_topk_is_the_global_top_k_when_k_scores_lie_above_neg_inf(kind, block_n):
    """When the k-th largest score lies above NEG_INF, the tiles do not show:
    a score of the global top k is in its own tile's top k, and candidates
    above NEG_INF come in index order, so the reference's function is the
    global top k by (value desc, index asc)."""
    rng = np.random.default_rng(block_n + len(kind))
    n, k = 1500, 40
    sc = rng.standard_normal(n).astype(np.float32)
    if kind == "ties":
        sc = np.round(sc * 2) / 2
    elif kind == "mostly_minus_inf":
        sc[rng.random(n) < 0.95] = -np.inf
    elif kind == "nan":
        sc[rng.random(n) < 0.01] = np.nan
    assert above_neg_inf(sc) >= k
    vals, idx = check_topk(sc, k, block_n)       # plain == Pallas kernel in interpret mode
    want_v, want_i = global_topk(sc, k)
    assert idx.tolist() == want_i.tolist()
    np.testing.assert_array_equal(vals.numpy(), want_v)


def test_topk_ties_straddling_tiles_at_the_kth_value():
    """The k-th value tied on both sides of tile boundaries: the lower index
    wins, as in the global order."""
    sc = np.full(256, -1.0, np.float32)
    sc[[3, 40, 70, 200]] = [9.0, 8.0, 7.0, 6.0]
    sc[[31, 32, 63, 64, 127, 128]] = 2.0         # tiles of 32: each pair straddles a boundary
    vals, idx = check_topk(sc, 7, 32)
    assert idx.tolist() == [3, 40, 70, 200, 31, 32, 63]
    assert idx.tolist() == global_topk(sc, 7)[1].tolist()


@pytest.mark.parametrize("case", ["all_minus_inf", "k_past_the_tile", "few_finite_over_tiles",
                                  "exactly_neg_inf"])
def test_topk_fewer_than_k_above_neg_inf_is_the_quirk(case):
    """With fewer than k scores above NEG_INF the tiles do show: each tile's
    rounds past its scores hand on its lowest NEG_INF slot again (padding, a
    masked winner or a score of exactly -3e38), which outranks -inf.  The
    port follows the Pallas kernel there, not the global top k."""
    rng = np.random.default_rng(len(case))
    if case == "all_minus_inf":
        sc, k, bn = np.full(300, -np.inf, np.float32), 8, 64
    elif case == "k_past_the_tile":
        sc, k, bn = rng.standard_normal(20).astype(np.float32), 40, 16
    elif case == "few_finite_over_tiles":
        sc = np.full(2000, -np.inf, np.float32)
        sc[rng.choice(2000, 6, replace=False)] = rng.standard_normal(6)
        k, bn = 16, 128
    else:
        sc = np.full(500, -np.inf, np.float32)
        sc[rng.choice(500, 12, replace=False)] = tk.NEG_INF
        sc[[7, 300]] = 1.0
        k, bn = 10, 64
    assert above_neg_inf(sc) < k
    vals, idx = check_topk(sc, k, bn)
    assert idx.tolist() != global_topk(sc, k)[1].tolist()


def test_topk_other_float_types():
    """bf16 and fp64 scores are compared in fp32, as the reference casts."""
    sc = scores_of(11, 500)
    for dtype, jdtype in ((torch.bfloat16, jnp.bfloat16), (torch.float64, jnp.float32)):
        got = ops.topk_scores(torch.from_numpy(sc).to(dtype), 8, block_n=128)
        want = jops.topk_scores(jnp.asarray(sc).astype(jdtype), 8, block_n=128)
        assert (got[1].numpy() == np.asarray(want[1])).all()
        np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))


# ------------------------------------------------------------------- Borda
def ballots_of(r, s, n):
    """tests/test_kernels.py's ballots: permutations cut to s, the first
    ballot truncated with -1 pads."""
    ballots = np.stack([np.random.default_rng(i).permutation(max(n, s))[:s]
                        for i in range(r)]).astype(np.int32)
    if r > 1:
        ballots[0, -2:] = -1
    return ballots


@pytest.mark.parametrize("shape", BORDA_SWEEP, ids=ident)
def test_borda_equals_reference_kernel_and_oracle(shape):
    r, s, n = shape
    ballots = ballots_of(r, s, n)
    got = ops.borda_count(torch.from_numpy(ballots), n, block_items=64, block_ballots=4)
    assert got.dtype == torch.float32 and got.shape == (n,)
    want = pallas_borda(jnp.asarray(ballots), n, block_items=64, block_ballots=4,
                        interpret=True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got.numpy(), np.asarray(jref.borda_ref(jnp.asarray(ballots), n)))
    np.testing.assert_array_equal(got.numpy(), np.asarray(jops.borda_count(jnp.asarray(ballots), n)))


def test_borda_takes_ballots_past_2_24_points():
    """8192 ballots of 64 (17 M points in all) go through as in the
    reference; each item's sum stays an exact fp32 integer."""
    ballots = ballots_of(8192, 64, 64)
    got = ops.borda_count(torch.from_numpy(ballots), 64)
    np.testing.assert_array_equal(got.numpy(), np.asarray(jref.borda_ref(jnp.asarray(ballots), 64)))


def test_borda_ids_past_n_items_and_the_width_quirk():
    """Ids at or above ``n_items`` count nothing; a short ballot's slots are
    worth S - p with S the matrix width (``borda_matrix``'s rule)."""
    from repro_torch.core.optimizer.borda import borda_matrix, borda_scores
    ballots = np.array([[0, 1, 2], [2, 0, -1], [5, 3, 1]], np.int32)
    got = ops.borda_count(torch.from_numpy(ballots), 3)
    np.testing.assert_array_equal(got.numpy(), np.asarray(jref.borda_ref(jnp.asarray(ballots), 3)))
    assert got.tolist() == [5.0, 3.0, 4.0]   # id 5 and id 3 add nothing
    assert got.tolist() == borda_matrix(np.where(ballots < 3, ballots, -1), 3).tolist()
    assert borda_scores([[0, 1, 2], [2, 0]], [0, 1, 2]) == {0: 4.0, 1: 2.0, 2: 3.0}


# (r, s, n, route): the optimizer's ballots; n_items at and past the
# one-block limit; slots at and past it; the large timed shape; one wide
# ballot; 2^22 ballots; items past the partials' cap; no ballot
BORDA_ROUTES = [(4, 8, 8, "one_block"), (64, 64, 4096, "one_block"), (64, 64, 4097, "grid"),
                (256, 64, 100, "one_block"), (257, 64, 100, "grid"), (4096, 64, 1024, "grid"),
                (1, 65536, 65536, "grid"), (1 << 22, 8, 8, "grid"), (3, 5, 1 << 25, "grid"),
                (0, 8, 8, "one_block")]


@pytest.mark.parametrize("case", BORDA_ROUTES, ids=ident)
def test_borda_plan_routes(case):
    """One block where the counts fit shared memory and the slots are few
    (so few that its 32-bit counts cannot overflow), else a grid whose runs of slots cover every slot, at most
    GRID_MAX_SLOT_BLOCKS of them and their partials within
    GRID_MAX_PARTIALS unless one run is all there can be."""
    r, s, n, route = case
    plan = bc.borda_plan(r, s, n)
    assert plan.route == route
    if route == "one_block":
        assert plan.slot_blocks == 0
        assert n <= bc.BLOCK_ITEMS and r * s <= bc.ONE_BLOCK_SLOTS
        assert r * s * s <= 2 ** 28     # its 32-bit counts cannot overflow
        return
    per_block = -(-r * s // plan.slot_blocks)
    assert 1 <= plan.slot_blocks <= bc.GRID_MAX_SLOT_BLOCKS
    assert (plan.slot_blocks - 1) * per_block < r * s
    assert plan.slot_blocks * n <= max(n, bc.GRID_MAX_PARTIALS)


@pytest.mark.parametrize("shape", [(257, 64, 100), (300, 64, 300), (4, 16, 5000), (5000, 4, 9)],
                         ids=ident)
def test_borda_grid_partials_sum_to_the_points(shape):
    """The grid route's arithmetic: each block counts its run of slots for
    its range of items in integers, the partials are summed and rounded
    once.  Equal to the plain version, ids past n_items counting nothing."""
    r, s, n = shape
    ballots = np.random.default_rng(r).integers(-1, 2 * n, size=(r, s)).astype(np.int32)
    plan = bc.borda_plan(r, s, n)
    assert plan.route == "grid"
    flat = ballots.reshape(-1)
    pts = s - np.arange(r * s) % s
    per_block = -(-r * s // plan.slot_blocks)
    partial = np.zeros((plan.slot_blocks, n), np.int64)
    for sb in range(plan.slot_blocks):
        run = slice(sb * per_block, (sb + 1) * per_block)
        for lo in range(0, n, bc.BLOCK_ITEMS):
            hi = min(n, lo + bc.BLOCK_ITEMS)
            ids, p = flat[run], pts[run]
            mine = (ids >= lo) & (ids < hi)
            np.add.at(partial[sb], ids[mine], p[mine])
    got = partial.sum(0).astype(np.float32)
    np.testing.assert_array_equal(got, bc.borda_count_plain(torch.from_numpy(ballots), n).numpy())


# -------------------------------------------------------------- wrappers
def test_cpu_wrappers_launch_nothing():
    tk.topk_scores.launches = bc.borda_count.launches = 0
    ops.topk_scores(torch.from_numpy(scores_of(1, 64)), 4)
    ops.borda_count(torch.from_numpy(ballots_of(3, 5, 8)), 8)
    assert tk.topk_scores.launches == bc.borda_count.launches == 0


def test_argument_checks():
    t = lambda *shape, dtype=torch.float32: torch.empty(shape, dtype=dtype,  # noqa: E731
                                                        device="meta")
    with pytest.raises(ValueError, match="scores must be"):
        tk.check_args(t(4, 4), 2, 64)
    with pytest.raises(TypeError, match="floating"):
        tk.check_args(t(8, dtype=torch.int32), 2, 64)
    with pytest.raises(ValueError, match="k = 0"):
        tk.check_args(t(8), 0, 64)
    with pytest.raises(ValueError, match="tile of"):
        tk.check_args(t(20000), 4, 16384)
    with pytest.raises(ValueError, match="contiguous"):
        tk.check_args(t(8, 2)[:, 0], 2, 64)
    with pytest.raises(TypeError, match="int32"):
        bc.check_args(t(4, 4, dtype=torch.int64), 8)
    with pytest.raises(ValueError, match="R, S"):
        bc.check_args(t(4, dtype=torch.int32), 8)
    bc.check_args(t(8192, 64, dtype=torch.int32), 8)      # 17 M points in all: taken
    with pytest.raises(RuntimeError, match="topk_scores"):
        ops.topk_scores(t(64), 4)
    with pytest.raises(RuntimeError, match="borda_count"):
        ops.borda_count(t(4, 8, dtype=torch.int32), 8)


def test_bounds():
    # one compare a score and one a candidate, whatever k the tiles run
    assert tk.operations(1 << 20, 64, 1024) == (1 << 20) + 1024 * 64
    ms, by = tk.bound_ms(1 << 20, 64, 4)    # 4 MB of fp32 scores outweigh 1.1 M compares
    assert by == "bytes" and ms == pytest.approx(1e3 * ((1 << 22) + 512) / 3.35e12)
    ms, by = tk.bound_ms(1 << 20, 256, 2)   # bf16 scores and k 256: still the bytes
    assert by == "bytes" and ms == pytest.approx(1e3 * ((1 << 21) + 2048) / 3.35e12)
    ms, by = tk.bound_ms(10, 5, 4)
    assert by == "bytes" and ms == pytest.approx(1e3 * (40 + 40) / 3.35e12)
    ms, by = bc.bound_ms(4096, 64, 1024)
    assert by == "bytes" and ms == pytest.approx(1e3 * (4096 * 64 * 4 + 1024 * 4) / 3.35e12)
