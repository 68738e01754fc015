"""Borda-count points of a ballot matrix: the CUDA kernel's wrapper and its
plain version.

Counterpart of ``src/repro/kernels/borda_count.py`` (``borda_count``, the
Pallas TPU kernel) and of ``src/repro/kernels/ref.py`` (``borda_ref``, here
:func:`borda_count_plain`).

Source note.  ``csrc/borda_count.cu`` replaces the Pallas kernel
``repro/kernels/borda_count.py::borda_count``, a one-hot matrix product that
stood in for the scatter atomics the TPU lacks.  On the card one thread per
ballot slot ``(r, p)`` adds ``S - p`` to its item's 64-bit integer count
with ``atomicAdd``; ``-1`` pads and ids ``>= n_items`` add nothing; a second
launch rounds each count to fp32.  The adds run in no fixed order but are
exact, being integer adds, so no size is refused.  Up to 2^24 points per item
the result equals the reference's fp32 sums; above, the exact sum rounded
once, where :func:`borda_count_plain`'s fp32 sums may differ in the last
bit.  Bound by bytes: each id is read once and each point written once
(:func:`bound_ms`).

Points use the matrix width S, as the reference's kernel and
``core/optimizer/borda.py::borda_matrix`` do; ``borda_scores`` gives a short
ballot its own length instead.

A CUDA tensor goes to the kernel or raises; only a CPU tensor takes the plain
version.  ``borda_count.launches`` counts kernel launches.
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from . import _build

HBM_BYTES_PER_S = 3.35e12          # H100 SXM data sheet


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


def borda_count(ballots, n_items: int, *, block_items: int = 128, block_ballots: int = 8):
    """ballots (R, S) int32 (-1 pads) -> points (n_items,) fp32; slot p is
    worth S - p.  ``block_items`` and ``block_ballots`` are the reference's
    tiling hints and cannot change the result: the kernel takes one thread
    per slot."""
    del block_items, block_ballots
    check_args(ballots, n_items)
    if ballots.device.type == "cpu":
        return borda_count_plain(ballots, n_items)
    if ballots.device.type != "cuda":
        raise RuntimeError(f"no borda_count kernel for {ballots.device}")
    fn = _launcher()
    r, s = ballots.shape
    counts = torch.empty((n_items,), dtype=torch.int64, device=ballots.device)
    points = torch.empty((n_items,), dtype=torch.float32, device=ballots.device)
    with torch.cuda.device(ballots.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(ballots.data_ptr(), r, s, n_items, counts.data_ptr(), points.data_ptr(),
                stream)
    if rc != 0:
        raise RuntimeError(f"borda_count_launch failed with code {rc} for ballots "
                           f"{tuple(ballots.shape)}, n_items {n_items}")
    borda_count.launches += 1
    return points


borda_count.launches = 0


def _launcher():
    fn = _build.load("borda_count").borda_count_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] + [ctypes.c_int] * 3 + [ctypes.c_void_p] * 3
        fn.restype = ctypes.c_int
    return fn


def live_bytes(r: int, s: int, n_items: int) -> int:
    """Bytes the function must move: each ballot id once, each point once."""
    return r * s * 4 + n_items * 4


def bound_ms(r: int, s: int, n_items: int):
    """Least time an H100 could take: :func:`live_bytes` over the memory
    rate (one add per slot is far below any compute peak).  Returns
    ``(ms, "bytes")``."""
    return 1e3 * live_bytes(r, s, n_items) / HBM_BYTES_PER_S, "bytes"
