"""MoE top-k gating: the CUDA kernel's wrapper and its plain version.

Counterpart of ``src/repro/kernels/moe_gating.py`` (``moe_gating``, the
Pallas TPU kernel) and of ``src/repro/kernels/ref.py`` (``moe_gating_ref``,
here :func:`moe_gating_plain`).

Source note.  ``csrc/moe_gating.cu`` replaces the Pallas kernel
``repro/kernels/moe_gating.py::moe_gating``.  Per token: the top-k experts
(the lower index wins a tie), the softmax over their logits, and each
slot's row-major arrival rank within its expert.  The ranks run across all
tokens, which the TPU kernel got from a counter carried across its
sequential grid.  On the card (:func:`gating_plan`): a lane holds a token a
round, at E 8 its whole row in registers (16-byte loads); a warp ranks its
tokens by one ``__ballot_sync`` an expert and round, one warp-level scan an
expert turns the warps' totals into offsets; up to :func:`one_launch_limit`
tokens one launch of one block, or of a cluster of up to 8 blocks that read
the earlier blocks' totals from their shared memory; past it a grid writes
each block's totals and a second launch adds the earlier blocks' totals to
each block's ranks.  Every rank is a sum of integers, so it is exact and the
same on every run.  Bound by bytes: each logit is read once
(:func:`bound_ms`); at a forward pass's token counts the launch dominates.  The first design (one
block of 1024 threads walking the tokens a tile at a time, K scalar passes
over each row, a 32-step serial sum an expert and tile) took 0.0164 ms at
Mixtral's T 2048 (``PERF.md`` §6).

A CUDA tensor goes to the kernel or raises; only a CPU tensor takes the plain
version.  ``moe_gating.launches`` counts calls that launched the kernel
(one a call, the grid route's second launch included).
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch
import torch.nn.functional as F

from ..launch.mesh import HBM_BW, PEAK_FLOPS_FP32
from . import _build

MAX_K = 8
MAX_EXPERTS = 256
SMS = 132                          # H100 SXM streaming multiprocessors
MAX_WARPS = 32                     # moe_gating.cu::kMaxWarps
ROW_EXPERTS = 8                    # rows held in registers; moe_gating.cu::kRowExperts
SMEM_BUDGET = 96 * 1024            # shared memory a block may take, bytes
MAX_CLUSTER = 8                    # blocks of a one-launch cluster; moe_gating.cu::kMaxCluster
GRID_WARPS = 8                     # warps a block of a cluster not yet full, and of the grid route
GRID_BLOCKS = 2 * SMS              # blocks the grid route fills before a lane takes more rounds
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


class GatingPlan(NamedTuple):
    """How the kernel covers T tokens (``moe_gating.cu``): ``blocks`` blocks
    of ``warps`` warps, each lane a token a round for ``rounds`` rounds, so a
    block holds ``span`` consecutive tokens; at E 8 the rows sit in
    registers (``rows_in_registers``), else a warp stages its round's rows
    in shared memory.  ``route`` "one_block" and "cluster" are one launch
    (a cluster's blocks read the earlier blocks' totals from their shared
    memory); "grid" adds a second launch that offsets each block's ranks by
    the earlier blocks' totals."""
    route: str
    rows_in_registers: bool
    warps: int
    rounds: int
    blocks: int

    @property
    def span(self) -> int:
        return self.warps * 32 * self.rounds


def max_rounds(k: int) -> int:
    """Rounds a lane may hold: its 2 k slots stay in registers until the
    block's scan (``moe_gating.cu::max_rounds``)."""
    return 2 if k <= 4 else 1


def max_warps(e: int) -> int:
    """Warps a block of E experts may have: a count per expert and warp,
    and away from E 8 a staged round of 32 rows at an odd stride, within
    ``SMEM_BUDGET``."""
    per_warp = 4 * e + (0 if e == ROW_EXPERTS else 4 * 32 * (e | 1))
    return max(1, min(MAX_WARPS, (SMEM_BUDGET - 8 * e) // per_warp))


def smem_bytes(plan: GatingPlan, e: int) -> int:
    """Dynamic shared memory of a block of ``plan`` (the launcher's sum)."""
    return 4 * (e * (plan.warps + 2)
                + (0 if plan.rows_in_registers else plan.warps * 32 * (e | 1)))


def one_launch_limit(e: int, k: int) -> int:
    """The most tokens one launch takes: a full cluster."""
    return MAX_CLUSTER * max_warps(e) * 32 * max_rounds(k)


def gating_plan(t: int, e: int, k: int) -> GatingPlan:
    """The route for logits (T, E) and top k.  Up to :func:`one_launch_limit`
    one launch: blocks of ``GRID_WARPS`` warps and one round while there are
    fewer than ``MAX_CLUSTER`` of them, then more warps and rounds a block;
    past it blocks of ``GRID_WARPS`` warps, one round each until there would
    be more than ``GRID_BLOCKS`` of them."""
    regs = e == ROW_EXPERTS
    wmax, rmax = max_warps(e), max_rounds(k)
    if t <= one_launch_limit(e, k):
        blocks = min(MAX_CLUSTER, -(-t // (32 * min(wmax, GRID_WARPS))))
        warps = min(wmax, -(-t // (32 * blocks)))
        rounds = -(-t // (32 * warps * blocks))
        blocks = -(-t // (32 * warps * rounds))
        return GatingPlan("one_block" if blocks == 1 else "cluster", regs, warps, rounds, blocks)
    warps = min(wmax, GRID_WARPS)
    rounds = min(rmax, -(-t // (GRID_BLOCKS * 32 * warps)))
    return GatingPlan("grid", regs, warps, rounds, -(-t // (32 * warps * rounds)))


def moe_gating_plain(logits, k: int):
    """logits (T, E) -> (idx (T, k) int32, gates (T, k) fp32, pos (T, k)
    int32), as ``ref.moe_gating_ref``: a stable descending sort (lower index
    first on a tie), softmax over the top k, and the arrival ranks from a
    one-hot cumulative sum over the row-major (token, choice) slots."""
    t, e = logits.shape
    vals, idx = torch.sort(logits.float(), dim=-1, descending=True, stable=True)
    vals, idx = vals[:, :k], idx[:, :k]
    gates = torch.softmax(vals, dim=-1)
    flat = idx.reshape(-1)
    onehot = F.one_hot(flat, e)
    pos = (torch.cumsum(onehot, dim=0) - 1).gather(1, flat[:, None])
    return idx.int(), gates, pos.reshape(t, k).int()


def check_args(logits, k: int) -> None:
    """Raise on anything the CUDA kernel cannot take, for a tensor on any
    device.  Touches no data."""
    if logits.dim() != 2:
        raise ValueError(f"logits must be (T, E), got {tuple(logits.shape)}")
    e = logits.shape[1]
    if not 1 <= e <= MAX_EXPERTS:
        raise ValueError(f"{e} experts: the kernel takes 1..{MAX_EXPERTS}")
    if not 1 <= k <= min(e, MAX_K):
        raise ValueError(f"k = {k} must lie in 1..min(E, {MAX_K}) = "
                         f"1..{min(e, MAX_K)}")
    if logits.dtype not in _DTYPE_CODE:
        raise TypeError(f"dtype {logits.dtype} not supported (float32, bfloat16)")
    if not logits.is_contiguous():
        raise ValueError("logits is not contiguous")


def moe_gating(logits, k: int, *, block_t: int = 256):
    """logits (T, E) -> (idx (T, k) int32, gates (T, k) fp32, pos (T, k)
    int32).  ``pos`` is the row-major arrival rank within each expert
    (capacity filtering ``pos < C`` is the caller's).  ``block_t`` is the
    reference's tiling hint and cannot change the result: :func:`gating_plan`
    sizes the kernel's blocks."""
    del block_t
    check_args(logits, k)
    if logits.device.type == "cpu":
        return moe_gating_plain(logits, k)
    if logits.device.type != "cuda":
        raise RuntimeError(f"no moe_gating kernel for {logits.device}")
    fn = _launcher()
    t, e = logits.shape
    dev = logits.device
    idx = torch.empty((t, k), dtype=torch.int32, device=dev)
    gates = torch.empty((t, k), dtype=torch.float32, device=dev)
    pos = torch.empty((t, k), dtype=torch.int32, device=dev)
    if t == 0:
        return idx, gates, pos
    plan = gating_plan(t, e, k)
    if plan.rows_in_registers and logits.data_ptr() % 16:
        logits = logits.clone()            # the 16-byte row loads need an aligned start
    counts = (torch.empty((plan.blocks * e,), dtype=torch.int32, device=dev)
              if plan.route == "grid" else None)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(logits.data_ptr(), idx.data_ptr(), gates.data_ptr(), pos.data_ptr(),
                None if counts is None else counts.data_ptr(), t, e, k,
                _DTYPE_CODE[logits.dtype], int(plan.rows_in_registers), plan.warps,
                plan.rounds, plan.blocks, stream)
    if rc != 0:
        raise RuntimeError(f"moe_gating_launch failed with code {rc} for "
                           f"logits {tuple(logits.shape)} {logits.dtype}, k {k}, {plan}")
    moe_gating.launches += 1
    return idx, gates, pos


moe_gating.launches = 0


def _launcher():
    fn = _build.load("moe_gating").moe_gating_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def live_bytes(t: int, e: int, k: int, itemsize: int) -> int:
    """Bytes the function must move: the logits once, idx, gates and pos
    once."""
    return t * e * itemsize + t * k * 12


def operations(t: int, e: int, k: int) -> int:
    """k rounds of a compare over the E logits, and the softmax and rank
    arithmetic (about four operations a slot), per token."""
    return t * (k * e + 4 * k)


def bound_ms(t: int, e: int, k: int, itemsize: int):
    """Least time an H100 could take: the larger of :func:`live_bytes` over
    the memory rate and :func:`operations` over the fp32 peak.  Returns
    ``(ms, "bytes" | "operations")``."""
    return max((1e3 * live_bytes(t, e, k, itemsize) / HBM_BW, "bytes"),
               (1e3 * operations(t, e, k) / PEAK_FLOPS_FP32, "operations"))
