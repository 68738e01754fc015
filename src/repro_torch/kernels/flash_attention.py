"""Prefill (flash) attention: the CUDA kernel's wrapper and its plain version.

Counterpart of ``src/repro/kernels/flash_attention.py`` (``flash_attention``,
the Pallas TPU kernel) and of ``src/repro/kernels/ref.py``
(``attention_ref``, here :func:`flash_attention_plain`).

Source note.  ``csrc/flash_attention.cu`` replaces the Pallas kernel
``repro/kernels/flash_attention.py::flash_attention``.  On an H100 the
function does ``4 * hd`` operations per live (query, key) pair against
q, k, v and out read or written once, so at prefill lengths it is bound by
operations (:func:`bound_ms`): the tensor cores' 989 TFLOP/s for bf16 inputs,
67 TFLOP/s for fp32 ones (TF32 would not compute the same function).  The
design: one thread block per (batch * head, tile of query rows) that walks
only the key tiles the tile can see (causal and window bounds in the loop,
as ``pl.when(live)`` skipped dead blocks), reading kv head ``h // G``
directly (no copy of K/V per query head), with the running max, sum and
accumulator in fp32 registers.  bf16 inputs run on the tensor cores
(``wgmma``): two warpgroups over 128 query rows share each K and V tile of
64 keys, which stays bf16 in shared memory (128-byte swizzle), loaded by
``cp.async`` into a ring of two stages so that the next tile's load
overlaps this tile's products; the weights are rounded to bf16 in registers
and feed the second product from there.  fp32 inputs keep scalar FMAs over
64 query rows a block.  TMA and warp specialisation are later work.

A CUDA tensor goes to the kernel or raises; only a CPU tensor takes the plain
version.  ``flash_attention.launches`` counts kernel launches.
"""
from __future__ import annotations

import ctypes
import math

import numpy as np
import torch

from ..launch.mesh import HBM_BW, PEAK_FLOPS
from . import _build

NEG_INF = -1e30
SUPPORTED_HEAD_DIMS = (32, 64, 128)
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def attention_mask(sq: int, sk: int, *, causal: bool, window: int,
                   q_offset: int, device=None) -> torch.Tensor:
    """(Sq, Sk) bool: query row i (absolute position ``q_offset + i``) sees
    key j."""
    rows = torch.arange(sq, device=device)[:, None] + q_offset
    cols = torch.arange(sk, device=device)[None, :]
    mask = torch.ones((sq, sk), dtype=torch.bool, device=device)
    if causal:
        mask &= cols <= rows
    if window:
        mask &= cols > rows - window
    return mask


def flash_attention_plain(q, k, v, *, causal: bool = True, window: int = 0,
                          q_offset: int = 0):
    """Masked attention in fp32, then cast to ``q.dtype``.  q (B, H, Sq, hd);
    k, v (B, KV, Sk, hd).  A row with no live key at all averages every key,
    as the reference's oracle does (the kernel gives 0 there; no caller has
    such rows: they need ``q_offset + Sq > Sk`` with a window)."""
    b, h, sq, hd = q.shape
    kv, sk = k.shape[1], k.shape[2]
    g = h // kv
    qg = q.reshape(b, kv, g, sq, hd).float() / math.sqrt(hd)
    scores = torch.einsum("bkgqd,bksd->bkgqs", qg, k.float())
    mask = attention_mask(sq, sk, causal=causal, window=window,
                          q_offset=q_offset, device=q.device)
    scores = torch.where(mask, scores, torch.full_like(scores, NEG_INF))
    w = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgqs,bksd->bkgqd", w, v.float())
    return out.reshape(b, h, sq, hd).to(q.dtype)


def check_args(q, k, v, *, window: int, q_offset: int) -> None:
    """Raise on anything the CUDA kernel cannot address, for a tensor on any
    device.  Touches no data, so it never synchronises."""
    if q.dim() != 4 or k.dim() != 4:
        raise ValueError(f"q must be (B, H, Sq, hd) and k, v (B, KV, Sk, hd); "
                         f"got {tuple(q.shape)}, {tuple(k.shape)}")
    b, h, _, hd = q.shape
    kb, kv, _, khd = k.shape
    if v.shape != k.shape:
        raise ValueError("k and v differ in shape")
    if kb != b or khd != hd:
        raise ValueError(f"k {tuple(k.shape)} does not fit q {tuple(q.shape)}")
    if hd not in SUPPORTED_HEAD_DIMS:
        raise ValueError(f"head_dim {hd} not supported: the kernel is built "
                         f"for {SUPPORTED_HEAD_DIMS}")
    if kv < 1 or h % kv:
        raise ValueError(f"n_heads {h} is not a multiple of n_kv_heads {kv}")
    if window < 0 or q_offset < 0:
        raise ValueError(f"window {window} and q_offset {q_offset} must be >= 0")
    if q.dtype not in _DTYPE_CODE:
        raise TypeError(f"dtype {q.dtype} not supported (float32, bfloat16)")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError("q, k and v must share one dtype")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device != q.device:
            raise ValueError(f"{name} lies on {t.device}, q on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} is not contiguous: the kernel addresses "
                             f"it in its (B, heads, S, hd) layout")
        if t.data_ptr() % 16:
            raise ValueError(f"{name} is not aligned to 16 bytes")


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0,
                    q_offset: int = 0, block_q: int = 128, block_k: int = 128):
    """q (B, H, Sq, hd); k, v (B, KV, Sk, hd).  Returns (B, H, Sq, hd) in
    ``q.dtype``.

    ``q_offset`` is the absolute position of query row 0 (normally
    ``Sk - Sq`` when the leading keys are a cached prefix); causal and window
    masks compare absolute positions.  ``block_q`` and ``block_k`` are the
    reference's tiling hints and cannot change the result: the kernel picks
    its own tiles (128 query rows and 64 keys in bf16; 64 query rows and 64
    keys, 32 at hd 128, in fp32)."""
    del block_q, block_k
    check_args(q, k, v, window=window, q_offset=q_offset)
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, window=window,
                                     q_offset=q_offset)
    if q.device.type != "cuda":
        raise RuntimeError(f"no flash_attention kernel for {q.device}")
    fn = _launcher()
    b, h, sq, hd = q.shape
    kv, sk = k.shape[1], k.shape[2]
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                b, h, kv, hd, sq, sk, int(bool(causal)), window, q_offset,
                _DTYPE_CODE[q.dtype], 1.0 / math.sqrt(hd), stream)
    if rc != 0:
        raise RuntimeError(
            f"flash_attention_launch failed with code {rc} for q "
            f"{tuple(q.shape)} {q.dtype}, k {tuple(k.shape)}")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0


def _launcher():
    fn = _build.load("flash_attention").flash_attention_launch
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 10
                       + [ctypes.c_float, ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def live_pairs(sq: int, sk: int, *, causal: bool, window: int,
               q_offset: int) -> int:
    """Number of (query, key) pairs the masks leave live, for one head."""
    rows = np.arange(sq, dtype=np.int64) + q_offset
    hi = np.minimum(sk, rows + 1) if causal else np.full(sq, sk)
    lo = np.maximum(0, rows - window + 1) if window else np.zeros(sq, np.int64)
    return int(np.maximum(hi - lo, 0).sum())


def needed_keys(sq: int, sk: int, *, causal: bool, window: int,
                q_offset: int) -> int:
    """Keys that some query row sees: the only ones that must be read."""
    if sq == 0:
        return 0
    hi = min(sk, q_offset + sq) if causal else sk
    lo = max(0, q_offset - window + 1) if window else 0
    return max(hi - lo, 0)


def bound_ms(b: int, h: int, kv: int, sq: int, sk: int, hd: int, dtype, *,
             causal: bool, window: int = 0, q_offset: int = 0):
    """Least time an H100 could take: the larger of the bytes (q and out, the
    K and V rows of :func:`needed_keys`, each once) over the memory rate and
    the operations (``4 * hd`` per live pair and head) over the peak for the
    input type.  Returns ``(ms, "bytes" | "operations")``."""
    item = torch.empty((), dtype=dtype).element_size()
    keys = needed_keys(sq, sk, causal=causal, window=window, q_offset=q_offset)
    nbytes = item * hd * (2 * b * h * sq + 2 * b * kv * keys)
    ops = 4 * hd * b * h * live_pairs(sq, sk, causal=causal, window=window,
                                      q_offset=q_offset)
    return max((1e3 * nbytes / HBM_BW, "bytes"),
               (1e3 * ops / PEAK_FLOPS[dtype], "operations"))
