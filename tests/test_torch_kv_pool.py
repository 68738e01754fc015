"""repro_torch KVBlockPool against the reference pool: one op script through
both gives identical free lists, refcounts, block ids, counters and gathered
KV (bitwise: a gather is a copy), plus the reference's contracts re-asserted
on the port."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced as jget
from repro.models import LM as JLM
from repro.models.layers import KVCache as JKVCache
from repro.serving import KVBlockPool as JPool, PoolExhausted as JPoolExhausted
from repro_torch.configs import get_reduced
from repro_torch.convert import to_tensor
from repro_torch.models import LM
from repro_torch.models.layers import KVCache
from repro_torch.serving import KVBlockPool, PoolExhausted

COUNTERS = ("free_blocks", "blocks_in_use", "peak_in_use", "total_allocs",
            "total_leased", "lease_shortfalls", "total_stashed", "total_unstashed")


@pytest.fixture(scope="module")
def lms():
    return JLM(jget("llama3-8b")), LM(get_reduced("llama3-8b"), device="cpu")


@pytest.fixture()
def pool(lms):
    return KVBlockPool(lms[1], num_blocks=17, block_size=8, device="cpu")


@pytest.fixture()
def pools(lms):
    return (JPool(lms[0], num_blocks=17, block_size=8),
            KVBlockPool(lms[1], num_blocks=17, block_size=8, device="cpu"))


def same_host_state(jp, tp):
    assert jp._free == tp._free
    assert (jp._ref == tp._ref).all()
    for name in COUNTERS:
        assert getattr(jp, name) == getattr(tp, name), name


def bits(x):
    if isinstance(x, torch.Tensor):
        return x.view(torch.int16).numpy()
    return np.asarray(x).view(np.int16)


def kv_pair(seed, shape):
    rng = np.random.default_rng(seed)
    k = jnp.asarray(rng.standard_normal(shape), jnp.bfloat16)
    v = jnp.asarray(rng.standard_normal(shape), jnp.bfloat16)
    return (k, v), (to_tensor(np.asarray(k)), to_tensor(np.asarray(v)))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_op_script_through_both_pools(pools, lms, seed):
    """A random script of alloc / lease / incref / decref / write / gather /
    stash / unstash, mirrored on both pools."""
    jp, tp = pools
    cfg = lms[1].cfg
    n = cfg.pattern[0][1]
    rng = np.random.default_rng(seed)
    runs: list[list[int]] = []
    for step in range(60):
        op = rng.choice(["alloc", "lease", "incref", "decref", "write", "stash"])
        if op == "alloc":
            k = int(rng.integers(1, 6))
            try:
                a = jp.alloc(k)
            except JPoolExhausted:
                with pytest.raises(PoolExhausted):
                    tp.alloc(k)
            else:
                assert a == tp.alloc(k)
                runs.append(a)
        elif op == "lease":
            k = int(rng.integers(1, 8))
            a, b = jp.lease(k), tp.lease(k)
            assert a == b
            if a is not None:
                runs.append(a)
        elif op == "incref" and runs:
            r = runs[int(rng.integers(len(runs)))]
            jp.incref(r), tp.incref(r)
            runs.append(list(r))
        elif op == "decref" and runs:
            r = runs.pop(int(rng.integers(len(runs))))
            assert jp.freeable(r) == tp.freeable(r)
            jp.decref(r), tp.decref(r)
        elif op == "write" and runs:
            r = runs[int(rng.integers(len(runs)))]
            s = len(r) * 8 - int(rng.integers(0, 8))
            (jk, jv), (tk, tv) = kv_pair(step, (n, 1, s, cfg.n_kv_heads, cfg.hd))
            jp.write([JKVCache(jk, jv, jnp.broadcast_to(jnp.arange(s), (n, s)))], [r])
            tp.write([KVCache(tk, tv, torch.arange(s).expand(n, s))], [r])
            jg, tg = jp.gather_stacked(r, s)[0], tp.gather_stacked(r, s)[0]
            assert (bits(tg.k) == bits(jg.k)).all() and (bits(tg.v) == bits(jg.v)).all()
            assert (tg.pos.numpy() == np.asarray(jg.pos)).all()
            assert (bits(tg.k[:, 0]) == bits(tk[:, 0])).all()
        elif op == "stash" and runs and jp.free_blocks:
            r = runs[int(rng.integers(len(runs)))]
            if len(r) <= jp.free_blocks:
                js, ts = jp.stash_blocks(r), tp.stash_blocks(r)
                assert (bits(ts[0][0]) == np.asarray(js[0][0]).view(np.int16)).all()
                dst = jp.alloc(len(r))
                assert dst == tp.alloc(len(r))
                jp.unstash_blocks(js, dst), tp.unstash_blocks(ts, dst)
                runs.append(dst)
        same_host_state(jp, tp)
    for src, dst in zip(jp.arenas, tp.arenas):
        assert (bits(dst.k[:, 1:]) == bits(src.k[:, 1:])).all()
        assert (bits(dst.v[:, 1:]) == bits(src.v[:, 1:])).all()
    for r in runs:
        jp.decref(r), tp.decref(r)
    same_host_state(jp, tp)
    assert tp.blocks_in_use == 0


# ------------------------------------- the reference's contracts, on the port
def test_alloc_free_roundtrip(pool):
    assert pool.free_blocks == 16            # block 0 reserved as dummy
    a = pool.alloc(5)
    assert len(a) == 5 and 0 not in a
    assert pool.blocks_in_use == 5 and pool.free_blocks == 11
    pool.decref(a)
    assert pool.blocks_in_use == 0 and pool.free_blocks == 16


def test_refcount_sharing(pool):
    run = pool.alloc(4)
    pool.incref(run)
    pool.decref(run)
    assert pool.blocks_in_use == 4           # still held
    pool.decref(run)
    assert pool.blocks_in_use == 0


def test_exhaustion_raises_and_leaves_state_clean(pool):
    a = pool.alloc(10)
    with pytest.raises(PoolExhausted):
        pool.alloc(7)
    assert pool.free_blocks == 6             # failed alloc took nothing
    pool.decref(a)
    assert pool.free_blocks == 16


def test_lease_success_shortfall_and_accumulation(pool):
    ids = pool.lease(6)
    assert ids is not None and len(ids) == 6
    assert pool.total_leased == 6 and pool.lease_shortfalls == 0
    held = pool.alloc(8)
    assert pool.lease(7) is None             # only 2 free: takes nothing
    assert pool.lease_shortfalls == 1 and pool.free_blocks == 2
    assert pool.lease(3) is None and pool.lease_shortfalls == 2
    pool.decref(ids), pool.decref(held)
    assert pool.free_blocks == 16 and pool.blocks_in_use == 0


def test_blocks_for_and_peak_tracking(pool):
    assert [pool.blocks_for(x) for x in (0, 1, 8, 9)] == [0, 1, 1, 2]
    a = pool.alloc(3)
    pool.alloc(5)
    pool.decref(a)
    pool.alloc(1)
    assert pool.peak_in_use == 8 and pool.blocks_in_use == 6


def test_freeable_counts_only_unshared(pool):
    run = pool.alloc(4)
    pool.incref(run[:2])
    assert pool.freeable(run) == 2
    pool.decref(run[:2])
    assert pool.freeable(run) == 4


def test_write_gather_roundtrip_in_place(pool, lms):
    cfg = lms[1].cfg
    n, b, s = cfg.pattern[0][1], 2, 21       # s deliberately un-aligned
    _, (k, v) = kv_pair(0, (n, b, s, cfg.n_kv_heads, cfg.hd))
    arena_k = pool.arenas[0].k
    rows = [pool.alloc(pool.blocks_for(s)) for _ in range(b)]
    pool.write([KVCache(k, v, torch.arange(s).expand(n, s))], rows)
    assert pool.arenas[0].k is arena_k       # the arena keeps its identity
    for r in range(b):
        got = pool.gather_stacked(rows[r], s)[0]
        assert torch.equal(got.k[:, 0], k[:, r]) and torch.equal(got.v[:, 0], v[:, r])
        assert got.k.shape == (n, 1, s, cfg.n_kv_heads, cfg.hd)
    # the partial last block is zero-padded
    assert not pool.arenas[0].k[:, rows[0][-1], s % 8:].any()


@pytest.mark.parametrize("start", [0, 8])
def test_write_with_lengths_is_each_row_written_alone(lms, start):
    """Rows of one write holding unequal lengths (one row given no blocks)
    land as if each row's first ``length`` positions were written on their
    own: the same arena bits, the tails of last blocks zero."""
    cfg = lms[1].cfg
    n, s = cfg.pattern[0][1], 29
    _, (k, v) = kv_pair(3, (n, 5, s, cfg.n_kv_heads, cfg.hd))
    caches = [KVCache(k, v, torch.arange(s).expand(n, s))]
    lengths = [29, 11 + start, 20, 29, 17 + start]
    merged, alone = (KVBlockPool(lms[1], num_blocks=17, block_size=8, device="cpu")
                     for _ in range(2))
    runs = [merged.alloc(merged.blocks_for(L - start)) for L in lengths]
    runs[3] = []                                   # a row with no run: skipped
    for L, run in zip(lengths, runs):
        if run:
            alone.alloc(len(run))
    merged.write(caches, runs, start=start, lengths=lengths)
    for r, (L, run) in enumerate(zip(lengths, runs)):
        if run:
            row = [KVCache(k[:, r:r + 1, :L], v[:, r:r + 1, :L], torch.arange(L).expand(n, L))]
            alone.write(row, [run], start=start)
    assert torch.equal(merged.arenas[0].k, alone.arenas[0].k)
    assert torch.equal(merged.arenas[0].v, alone.arenas[0].v)
    got = merged.gather_stacked(runs[1], lengths[1] - start)[0]
    assert torch.equal(got.k[:, 0], k[:, 1, start:lengths[1]])
    assert not merged.arenas[0].k[:, runs[1][-1], (lengths[1] - start) % 8:].any()
    with pytest.raises(AssertionError):           # a run short of its length
        merged.write(caches, [runs[1]], start=start, lengths=[29])


def test_write_rejects_unaligned_start_and_unequal_runs(pool, lms):
    cfg = lms[1].cfg
    n = cfg.pattern[0][1]
    z = torch.zeros((n, 2, 16, cfg.n_kv_heads, cfg.hd), dtype=torch.bfloat16)
    caches = [KVCache(z, z, torch.arange(16).expand(n, 16))]
    with pytest.raises(AssertionError):
        pool.write(caches, [pool.alloc(1)], start=3)
    with pytest.raises(AssertionError):
        pool.write(caches, [pool.alloc(2), pool.alloc(1)])


def test_stash_unstash_roundtrip_is_bit_identical(pool, lms):
    cfg = lms[1].cfg
    src, dst = pool.alloc(3), pool.alloc(3)
    assert not set(src) & set(dst)
    n = cfg.pattern[0][1]
    _, (vals, _) = kv_pair(1, (n, 3, pool.block_size, cfg.n_kv_heads, cfg.hd))
    pool.arenas[0].k[:, src] = vals
    pool.arenas[0].v[:, src] = -vals
    stash = pool.stash_blocks(src)
    assert stash[0][0].device.type == "cpu"
    pool.decref(src)                         # source may die while stashed
    pool.unstash_blocks(stash, dst)
    assert torch.equal(pool.arenas[0].k[:, dst], vals)
    assert torch.equal(pool.arenas[0].v[:, dst], -vals)
    assert pool.total_stashed == pool.total_unstashed == 3
    with pytest.raises(AssertionError):      # size mismatch is refused
        pool.unstash_blocks(stash, dst[:2])


def test_incref_decref_of_free_block_is_refused(pool):
    with pytest.raises(AssertionError):
        pool.incref([3])
    with pytest.raises(AssertionError):
        pool.decref([3])
