"""MoE top-k gating: the CUDA kernel's wrapper and its plain version.

Counterpart of ``src/repro/kernels/moe_gating.py`` (``moe_gating``, the
Pallas TPU kernel) and of ``src/repro/kernels/ref.py`` (``moe_gating_ref``,
here :func:`moe_gating_plain`).

Source note.  ``csrc/moe_gating.cu`` replaces the Pallas kernel
``repro/kernels/moe_gating.py::moe_gating``.  Per token: the top-k experts
(the lower index wins a tie), the softmax over their logits, and each
slot's row-major arrival rank within its expert.  The ranks run across all
tokens, which the TPU kernel got from a counter carried across its
sequential grid; on the card one thread block walks the tokens tile by tile
with the counters in shared memory (no atomics, so the ranks are exact and
the same on every run).  Bound by bytes: each logit is read once
(:func:`bound_ms`); at a forward pass's token counts the launch dominates.

A CUDA tensor goes to the kernel or raises; only a CPU tensor takes the plain
version.  ``moe_gating.launches`` counts kernel launches.
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from . import _build

MAX_K = 8
MAX_EXPERTS = 256
HBM_BYTES_PER_S = 3.35e12          # H100 SXM data sheet
FP32_FLOPS = 67e12                 # the ranks and the softmax are fp32 work
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


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
    reference's tiling hint and cannot change the result: the kernel walks
    1024 tokens a tile."""
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
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(logits.data_ptr(), idx.data_ptr(), gates.data_ptr(),
                pos.data_ptr(), t, e, k, _DTYPE_CODE[logits.dtype], stream)
    if rc != 0:
        raise RuntimeError(f"moe_gating_launch failed with code {rc} for "
                           f"logits {tuple(logits.shape)} {logits.dtype}, k {k}")
    moe_gating.launches += 1
    return idx, gates, pos


moe_gating.launches = 0


def _launcher():
    fn = _build.load("moe_gating").moe_gating_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
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
    return max((1e3 * live_bytes(t, e, k, itemsize) / HBM_BYTES_PER_S, "bytes"),
               (1e3 * operations(t, e, k) / FP32_FLOPS, "operations"))
