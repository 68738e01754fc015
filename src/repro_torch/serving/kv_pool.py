"""Block-paged KV pool: the ONE memory scheme behind serving.

Counterpart of ``src/repro/serving/kv_pool.py``.  The host half (free list,
refcounts, leases, counters) is carried over unchanged.  The device half
differs in one way: the arena is one tensor per decoder stack, updated IN
PLACE (``index_copy_`` here, ``index_put_`` in the decode step), where the
reference builds a new array with ``.at[].set`` and relies on buffer
donation.  ``self.arenas`` therefore keeps its identity for the pool's
lifetime.

On a serving mesh (``mesh=``) each process holds its slice of the
arenas: the kv heads its layers attend (``models.blocks.kv_heads_on``: kv
heads over ``model`` where they divide, else the heads its cut of the
q heads reads), every other dim, the block dim above all, replicated over
the data axes.  So
the free list, refcounts, leases and stashes below stay host-side and
mesh-oblivious: a block id addresses the same arena slice on every process,
and every process runs the same allocator decisions.  Keeping the block dim
replicated is the engine's job (it gathers row-split K/V over the data axes
before every write).

A fixed arena of per-layer KV blocks (one :class:`~..models.layers.PagedKV`
per decoder stack, leaves (n_layers, num_blocks, block_size, KV, hd)) with a
host-side free-list allocator, per-sequence block tables, and ref-counted
block sharing.  Two memory schemes ride it:

 * **prefix-cache entries** (engine LRU) hold their region KV as a *pinned
   block run*: probe window jobs gather the run into the dense view the
   suffix-only prefill consumes, and decode sequences whose prompt shares
   the prefix incref the run's full blocks and append private blocks after
   it instead of re-materializing the prefix;
 * **decode sequences** (continuous-batching rows) own an ordered run of
   blocks covering positions ``[0, class + budget)``; a finished row frees
   its private blocks *immediately* (decref; shared prefix blocks survive
   while the LRU or other rows still hold them), so vacated memory admits
   queued requests between decode steps.

Block 0 is a permanent dummy: padded block-table slots and bucket-dummy
rows point (and may write) there, and it is never allocated, so its garbage
is only ever read through a mask.  Allocation/refcounts are plain
Python/numpy; only the arenas live on the device.
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from ..device import resolve_device
from ..distributed.sharding import MODEL, axis_size
from ..models.blocks import kv_heads_on
from ..models.layers import KVCache, PagedKV, dtype_of


class PoolExhausted(RuntimeError):
    """Raised when an allocation cannot be satisfied even after the caller
    has evicted everything it is willing to evict."""


class KVBlockPool:
    def __init__(self, lm, num_blocks: int, block_size: int = 16,
                 device=None, mesh=None):
        """``device=None`` means CUDA and raises without it."""
        cfg = lm.cfg
        assert num_blocks >= 2, "need at least one real block beyond dummy 0"
        assert all(kind == "attn" for kind, _ in cfg.pattern), (
            "the paged pool holds full-attention KV only")
        self.block_size = block_size
        self.num_blocks = num_blocks
        self.device = resolve_device(device)
        dt = dtype_of(cfg.dtype)
        kv, hd = cfg.n_kv_heads, cfg.hd

        if mesh is not None:              # this process's kv heads
            kv = kv_heads_on(cfg, axis_size(mesh, MODEL),
                             int(mesh.get_local_rank(MODEL)))
        shapes = [(n, num_blocks, block_size, kv, hd) for _kind, n in cfg.pattern]
        self.arenas = [PagedKV(k=torch.zeros(s, dtype=dt, device=self.device),
                               v=torch.zeros(s, dtype=dt, device=self.device))
                       for s in shapes]
        # LIFO free list, block 0 (dummy) excluded for good
        self._free = list(range(num_blocks - 1, 0, -1))
        self._ref = np.zeros(num_blocks, np.int64)
        self.peak_in_use = 0
        self.total_allocs = 0
        # probe-row leases (see ServeEngine._lease_probe_blocks): transient
        # single-submission holds that arbitrate the same budget as decode
        # rows; counted separately so capacity reports can split persistent
        # occupancy from probe traffic
        self.total_leased = 0
        self.lease_shortfalls = 0
        # preemption traffic (see ServeEngine.paged_suspend/paged_resume):
        # blocks copied out to host stashes and scattered back
        self.total_stashed = 0
        self.total_unstashed = 0

    def _pin(self, si: int, arena):
        """The reference re-commits an eagerly updated arena to its
        canonical sharding.  The port's arenas are updated in place and keep
        their layout, so this checks that stack ``si``'s arena is still the
        pool's own and returns it."""
        assert arena is self.arenas[si], f"stack {si}: not the pool's arena"
        return arena

    def _ids(self, ids) -> torch.Tensor:
        return torch.as_tensor(np.asarray(list(ids), np.int64),
                               device=self.device)

    # ---------------------------------------------------------- allocator
    @property
    def free_blocks(self) -> int:
        return len(self._free)

    @property
    def blocks_in_use(self) -> int:
        return self.num_blocks - 1 - len(self._free)

    def blocks_for(self, n_tokens: int) -> int:
        return -(-max(n_tokens, 0) // self.block_size)

    def alloc(self, n: int) -> list[int]:
        """Allocate ``n`` blocks with refcount 1."""
        if n > len(self._free):
            raise PoolExhausted(
                f"need {n} blocks, {len(self._free)} free "
                f"(pool {self.num_blocks}, block_size {self.block_size})")
        ids = [self._free.pop() for _ in range(n)]
        self._ref[ids] = 1
        self.total_allocs += n
        self.peak_in_use = max(self.peak_in_use, self.blocks_in_use)
        return ids

    def lease(self, n: int) -> "list[int] | None":
        """Best-effort transient allocation: ``n`` blocks with refcount 1
        when the free list can host them, ``None`` otherwise (the caller
        proceeds with unpooled transient memory: a lease never raises and
        never evicts).  Released via :meth:`decref` like any run."""
        if n > len(self._free):
            self.lease_shortfalls += 1
            return None
        # ownership transfers to the lease holder, who decrefs the run
        ids = self.alloc(n)  # lint: disable=kv-pairing
        self.total_leased += n
        return ids

    def freeable(self, ids: Sequence[int]) -> int:
        """How many of ``ids`` would return to the free list on one decref
        (refcount 1: not shared with an LRU entry or another row)."""
        return sum(1 for i in ids if self._ref[i] == 1)

    def incref(self, ids: Sequence[int]) -> None:
        for i in ids:
            assert self._ref[i] > 0, f"incref of free block {i}"
            self._ref[i] += 1

    def decref(self, ids: Sequence[int]) -> None:
        """Drop one reference per id; blocks reaching 0 return to the free
        list (this IS ``free``: owners simply drop their reference)."""
        for i in ids:
            assert self._ref[i] > 0, f"decref of free block {i}"
            self._ref[i] -= 1
            if self._ref[i] == 0:
                self._free.append(int(i))

    # ------------------------------------------------- preemption stashes
    def stash_blocks(self, ids: Sequence[int]) -> list:
        """Copy the contents of ``ids`` to a host-side stash (the suspend
        half of decode-row preemption): per decoder stack, the (n, len(ids),
        block_size, KV, hd) K/V slabs as CPU tensors.  A stash is a plain
        value: it holds no pool references, so the caller decides when the
        source blocks are released."""
        idx = self._ids(ids)
        stash = [(a.k.index_select(1, idx).cpu(), a.v.index_select(1, idx).cpu())
                 for a in self.arenas]
        self.total_stashed += len(idx)
        return stash

    def unstash_blocks(self, stash: list, ids: Sequence[int]) -> None:
        """Scatter a stash back into ``ids`` (the resume half): the blocks
        need not be the ones stashed from, since the row's block TABLE
        carries the ordering, and a gather-out/scatter-back round trip is a
        copy of the stored bits."""
        ids = list(ids)
        assert stash and all(k.shape[1] == len(ids) for k, _ in stash), (
            "stash block count must match the destination run")
        idx = self._ids(ids)
        for si, (arena, (k, v)) in enumerate(zip(self.arenas, stash)):
            arena.k.index_copy_(1, idx, k.to(self.device))
            arena.v.index_copy_(1, idx, v.to(self.device))
            self._pin(si, arena)
        self.total_unstashed += len(ids)

    # ------------------------------------------------------ device arenas
    def write(self, stack_caches, row_blocks: Sequence[Sequence[int]],
              start: int = 0,
              lengths: Optional[Sequence[int]] = None) -> None:
        """Scatter prefill-computed KV into block runs: positions
        ``[start, lengths[r])`` of row ``r`` of ``stack_caches`` (a
        per-stack list of stacked :class:`KVCache`, leaves (n, B, S, KV,
        hd); ``lengths`` defaults to S for every row) land in
        ``row_blocks[r]`` in order.  ``start`` must be block-aligned;
        trailing bucket-dummy rows of the prefill batch (B > len(row_blocks))
        are dropped.  Given ``lengths``, runs may cover unequal block counts
        and a row given no blocks is skipped; without, every run covers the
        same count.  Positions of a run past its row's length are zeroed:
        readers mask by valid length, never by block occupancy.  The ids
        are uploaded once; unless every row covers its whole span, every
        (row, block) pair is gathered by one ``index_select``."""
        if not row_blocks:
            return
        bs = self.block_size
        assert start % bs == 0, "write start must be block-aligned"
        s = stack_caches[0].k.shape[2]
        if lengths is None:
            assert all(len(b) == len(row_blocks[0]) for b in row_blocks), (
                "rows of one write must cover equal block counts")
            lengths = [s] * len(row_blocks)
        nb = self.blocks_for(s - start)          # blocks a cache row spans
        rows = len(row_blocks)
        # every row its whole span: the gather is the identity, and the
        # positions past the span are the zeros of the pad
        whole = all(len(b) == nb for b in row_blocks) and all(
            length == s for length in lengths)
        if whole:
            idx = self._ids(i for b in row_blocks for i in b)[None]
        else:
            dst, src, valid = [], [], []
            for r, (blocks, length) in enumerate(zip(row_blocks, lengths)):
                span = length - start
                assert not blocks or (
                    span <= s - start
                    and self.blocks_for(span) <= len(blocks) <= nb), (
                    f"row {r}: run of {len(blocks)} blocks for {span} positions")
                for j, b in enumerate(blocks):
                    dst.append(b)
                    src.append(r * nb + j)
                    valid.append(min(max(span - j * bs, 0), bs))
            if not dst:
                return
            idx = self._ids(dst + src + valid).view(3, -1)
            drop = (torch.arange(bs, device=self.device)
                    >= idx[2, :, None])[None, :, :, None, None]
        pad = nb * bs - (s - start)
        for si, (arena, cache) in enumerate(zip(self.arenas, stack_caches)):
            n = cache.k.shape[0]

            def to_blocks(leaf):
                leaf = leaf[:, :rows, start:]
                if pad:
                    leaf = F.pad(leaf, (0, 0, 0, 0, 0, pad))
                leaf = leaf.reshape(n, rows * nb, bs, *leaf.shape[3:])
                if whole:
                    return leaf
                return leaf.index_select(1, idx[1]).masked_fill_(drop, 0)

            arena.k.index_copy_(1, idx[0], to_blocks(cache.k))
            arena.v.index_copy_(1, idx[0], to_blocks(cache.v))
            self._pin(si, arena)

    def gather_stacked(self, block_ids: Sequence[int], length: int):
        """Materialize a block run as the dense per-stack cache list the
        chunked-prefill path consumes: :class:`KVCache` with k/v
        (n, 1, length, KV, hd) and pos (n, length).  A gather is a copy of
        the stored bits."""
        ids = self._ids(block_ids)
        out = []
        for arena in self.arenas:
            n = arena.k.shape[0]

            def dense(leaf):
                g = leaf.index_select(1, ids)        # (n, nb, bs, kv, hd)
                g = g.reshape(n, 1, -1, *g.shape[3:])
                return g[:, :, :length]

            pos = torch.arange(length, dtype=torch.int32,
                               device=self.device).expand(n, length)
            out.append(KVCache(dense(arena.k), dense(arena.v), pos))
        return out
