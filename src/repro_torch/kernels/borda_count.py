"""Borda-count points of a ballot matrix: the CUDA kernel's wrapper and its
plain version.

Counterpart of ``src/repro/kernels/borda_count.py`` (``borda_count``, the
Pallas TPU kernel) and of ``src/repro/kernels/ref.py`` (``borda_ref``, here
:func:`borda_count_plain`).

Source note.  ``csrc/borda_count.cu`` replaces the Pallas kernel
``repro/kernels/borda_count.py::borda_count``, a one-hot matrix product that
stood in for the scatter atomics the TPU lacks.  On the card a block adds
``S - p`` for each ballot slot ``(r, p)`` to its item's integer count with
shared-memory ``atomicAdd``; ``-1`` pads and ids ``>= n_items`` add
nothing; each count is rounded to fp32 once.  The adds run in no fixed
order but are exact, being integer adds that cannot overflow (32-bit on the
one-block route, whose slots and points are each at most ``ONE_BLOCK_SLOTS``,
64-bit on the grid), so no size is refused.  Up to 2^24
points per item the result equals the reference's fp32 sums; above, the
exact sum rounded once, where :func:`borda_count_plain`'s fp32 sums may
differ in the last bit.  Bound by bytes: each id is read once and each
point written once (:func:`bound_ms`); at the optimizer's few ballots, by
the launch alone.  The first design (a memset of global counts, global
atomics, a rounding launch) cost three device operations and two
allocations there.  Now :func:`borda_plan` picks the route: one block, one
launch and the points the only allocation, wherever the counts fit shared
memory and the slots are few; else a grid whose blocks count runs of slots
in shared memory and write partial counts, summed and rounded by a second
launch (no global atomic, no memset), which halved the first design's time
at 4096 ballots of 64 on the H100 (``PERF.md`` §5).

Points use the matrix width S, as the reference's kernel and
``core/optimizer/borda.py::borda_matrix`` do; ``borda_scores`` gives a short
ballot its own length instead.

A CUDA tensor goes to the kernel or raises; only a CPU tensor takes the plain
version.  ``borda_count.launches`` counts calls that launched the kernel
(one a call, its second launch included).
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch
import torch.nn.functional as F

from ..launch.mesh import HBM_BW
from . import _build

SMS = 132                          # H100 SXM streaming multiprocessors
BLOCK_ITEMS = 4096                 # items a block counts (32 KB at 64 bits); borda_count.cu::kBlockItems
ONE_BLOCK_SLOTS = 16384            # slots one block of 512 threads takes in one launch (2^28 points)
GRID_SLOTS = 4096                  # the least slots a block of the grid route takes
GRID_MAX_SLOT_BLOCKS = 2 * SMS
GRID_MAX_PARTIALS = 1 << 24        # partial counts (128 MB) the grid route may write


def borda_count_plain(ballots, n_items: int):
    """ballots (R, S) int32 (-1 pads) -> points (n_items,) fp32, as
    ``ref.borda_ref``: a one-hot of the ids (pads and ids past ``n_items``
    match nothing) contracted with the position points ``S - p``."""
    s = ballots.shape[1]
    pts = torch.arange(s, 0, -1, dtype=torch.float32, device=ballots.device)
    ids = ballots.long()
    ids = torch.where((ids < 0) | (ids >= n_items), n_items, ids)
    onehot = F.one_hot(ids, n_items + 1)[..., :n_items].float()
    return torch.einsum("rsn,s->n", onehot, pts)


def check_args(ballots, n_items: int) -> None:
    """Raise on anything the CUDA kernel cannot take, for a tensor on any
    device.  Touches no data."""
    if ballots.dim() != 2:
        raise ValueError(f"ballots must be (R, S), got {tuple(ballots.shape)}")
    if ballots.dtype != torch.int32:
        raise TypeError(f"ballots must be int32, got {ballots.dtype}")
    if n_items < 1:
        raise ValueError(f"n_items = {n_items} must be >= 1")
    if ballots.numel() >= 2 ** 31:
        raise ValueError(f"{ballots.numel()} ballot slots do not fit int32 positions")
    if not ballots.is_contiguous():
        raise ValueError("ballots is not contiguous")


class BordaPlan(NamedTuple):
    """How the kernel counts: ``route`` "one_block" (one launch) or "grid"
    (``slot_blocks`` runs of slots times the ranges of ``BLOCK_ITEMS``
    items, then a summing launch)."""
    route: str
    slot_blocks: int


def borda_plan(r: int, s: int, n_items: int) -> BordaPlan:
    """The route for ballots (R, S) over ``n_items`` items."""
    n_slots = r * s
    if n_items <= BLOCK_ITEMS and n_slots <= ONE_BLOCK_SLOTS:
        return BordaPlan("one_block", 0)
    return BordaPlan("grid", max(1, min(-(-n_slots // GRID_SLOTS), GRID_MAX_SLOT_BLOCKS,
                                        GRID_MAX_PARTIALS // n_items)))


def borda_count(ballots, n_items: int, *, block_items: int = 128, block_ballots: int = 8):
    """ballots (R, S) int32 (-1 pads) -> points (n_items,) fp32; slot p is
    worth S - p.  ``block_items`` and ``block_ballots`` are the reference's
    tiling hints and cannot change the result: :func:`borda_plan` sizes the
    kernel's blocks.  One call counts one launch, whatever the route."""
    del block_items, block_ballots
    check_args(ballots, n_items)
    if ballots.device.type == "cpu":
        return borda_count_plain(ballots, n_items)
    if ballots.device.type != "cuda":
        raise RuntimeError(f"no borda_count kernel for {ballots.device}")
    fn = _launcher()
    r, s = ballots.shape
    plan = borda_plan(r, s, n_items)
    dev = ballots.device
    points = torch.empty((n_items,), dtype=torch.float32, device=dev)
    partial = (torch.empty((plan.slot_blocks * n_items,), dtype=torch.int64, device=dev)
               if plan.slot_blocks else None)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(ballots.data_ptr(), r, s, n_items, plan.slot_blocks,
                None if partial is None else partial.data_ptr(), points.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"borda_count_launch failed with code {rc} for ballots "
                           f"{tuple(ballots.shape)}, n_items {n_items}, {plan}")
    borda_count.launches += 1
    return points


borda_count.launches = 0


def _launcher():
    fn = _build.load("borda_count").borda_count_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] + [ctypes.c_int] * 4 + [ctypes.c_void_p] * 3
        fn.restype = ctypes.c_int
    return fn


def live_bytes(r: int, s: int, n_items: int) -> int:
    """Bytes the function must move: each ballot id once, each point once."""
    return r * s * 4 + n_items * 4


def bound_ms(r: int, s: int, n_items: int):
    """Least time an H100 could take: :func:`live_bytes` over the memory
    rate (one add per slot is far below any compute peak).  Returns
    ``(ms, "bytes")``."""
    return 1e3 * live_bytes(r, s, n_items) / HBM_BW, "bytes"
