"""Paged decode attention: the CUDA kernel's wrapper and its plain version.

Counterpart of ``src/repro/kernels/paged_attention.py`` (``paged_attention``,
the Pallas TPU kernel) and of ``src/repro/kernels/ref.py``
(``paged_decode_attention_ref``, here :func:`paged_attention_plain`).

Source note.  ``csrc/paged_attention.cu`` replaces the Pallas kernel
``repro/kernels/paged_attention.py::paged_attention``.  On an H100 the
function is bound by bytes: the K and V rows of each valid token are read
once (a token's ``hd`` values for one kv head are a contiguous run, so a
block's invalid tail need not be fetched), so the least time is
``(sum_b ctx_b * KV * hd * 2 * itemsize + q + out + live table entries +
ctx_len) / 3.35 TB/s``; its two products are about one operation per byte,
far below what the card can do per byte moved.  The design is the dense
decode kernel's (``csrc/decode_tile.cuh``: one ``ring_walk`` loop, two row
maps): one thread block per (sequence, kv head, chunk of up to 8 query
heads) walks only the row's first ``min(ctx_len, MAXB * bs)`` positions
(the TPU grid fetched and masked all ``MAXB`` blocks); each position's
block id arrives by ``cp.async`` one ring ahead of its K and V rows, which
are staged in their stored type from the pool's native ``(NB, bs, KV, hd)``
layout (the TPU wrapper transposed both arenas on every call) into a ring
of three tiles, so two are in flight while one is folded; q, the running
max and sum and the accumulators stay in registers in fp32, and each staged
element is read once for all the query heads of the group.  The first
design staged each tile with synchronous loads, unpacked it to
fp32 in shared memory and kept the state there.  The keys are not split
across blocks.  :func:`bound_ms` gives the bound to hold measured times
against.

A CUDA tensor goes to the kernel or raises; only a CPU tensor takes the plain
version.  ``paged_attention.launches`` counts kernel launches.
"""
from __future__ import annotations

import ctypes
import math

import torch

from ..launch.mesh import HBM_BW
from . import _build

NEG_INF = -1e30
SUPPORTED_HEAD_DIMS = (8, 16, 32, 64, 128)
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def paged_attention_plain(q, k_pool, v_pool, tables, ctx_len):
    """Gather each sequence's block run into a dense view, then masked
    attention in fp32.  q: (B, H, hd); k_pool/v_pool (NB, bs, KV, hd);
    tables (B, MAXB) int block runs, 0-padded (block 0 is the pool's dummy);
    ctx_len (B,) valid lengths.  Returns (B, H, hd) in ``q.dtype``."""
    b, h, hd = q.shape
    bs, kv = k_pool.shape[1], k_pool.shape[2]
    maxb = tables.shape[1]
    g = h // kv
    flat = tables.reshape(-1).long()
    kg = k_pool.index_select(0, flat).reshape(b, maxb * bs, kv, hd).float()
    vg = v_pool.index_select(0, flat).reshape(b, maxb * bs, kv, hd).float()
    qg = q.reshape(b, kv, g, hd).float() / math.sqrt(hd)
    scores = torch.einsum("bkgd,bskd->bkgs", qg, kg)
    valid = (torch.arange(maxb * bs, device=q.device)[None, :]
             < ctx_len[:, None])
    scores = torch.where(valid[:, None, None, :], scores,
                         torch.full_like(scores, NEG_INF))
    w = torch.softmax(scores, dim=-1)
    # a masked slot has weight exactly 0, but 0 * inf/nan in a stale slot
    # would still poison the sum: zero those V rows as the kernels do
    vg = torch.where(valid[:, :, None, None], vg, torch.zeros_like(vg))
    out = torch.einsum("bkgs,bskd->bkgd", w, vg)
    return out.reshape(b, h, hd).to(q.dtype)


def check_args(q, k_pool, v_pool, tables, ctx_len) -> None:
    """Raise on anything the CUDA kernel cannot address.  Runs before any
    launch and touches no data, so it never synchronises."""
    if q.dim() != 3 or k_pool.dim() != 4:
        raise ValueError(f"q must be (B, H, hd) and pools (NB, bs, KV, hd); "
                         f"got {tuple(q.shape)}, {tuple(k_pool.shape)}")
    b, h, hd = q.shape
    nb, bs, kv, hd_pool = k_pool.shape
    if v_pool.shape != k_pool.shape:
        raise ValueError("k_pool and v_pool differ in shape")
    if hd_pool != hd or hd not in SUPPORTED_HEAD_DIMS:
        raise ValueError(f"head_dim {hd} (pool {hd_pool}) not supported: "
                         f"the kernel is built for {SUPPORTED_HEAD_DIMS}")
    if kv < 1 or h % kv:
        raise ValueError(f"n_heads {h} is not a multiple of n_kv_heads {kv}")
    if q.dtype not in _DTYPE_CODE:
        raise TypeError(f"dtype {q.dtype} not supported (float32, bfloat16)")
    if k_pool.dtype != q.dtype or v_pool.dtype != q.dtype:
        raise TypeError("q, k_pool and v_pool must share one dtype")
    if tables.dim() != 2 or tables.shape[0] != b or tables.shape[1] < 1:
        raise ValueError(f"tables must be (B, MAXB), got {tuple(tables.shape)}")
    if ctx_len.shape != (b,):
        raise ValueError(f"ctx_len must be (B,), got {tuple(ctx_len.shape)}")
    if tables.dtype != torch.int32 or ctx_len.dtype != torch.int32:
        raise TypeError("tables and ctx_len must be int32")
    for name, t in (("q", q), ("k_pool", k_pool), ("v_pool", v_pool),
                    ("tables", tables), ("ctx_len", ctx_len)):
        if t.device != q.device:
            raise ValueError(f"{name} lies on {t.device}, q on {q.device}")
        if not t.is_contiguous():
            raise ValueError(
                f"{name} is not contiguous: the kernel addresses the pool in "
                f"its native (NB, bs, KV, hd) layout and makes no copy")
    for name, t in (("q", q), ("k_pool", k_pool), ("v_pool", v_pool)):
        if t.data_ptr() % 16:
            raise ValueError(f"{name} is not aligned to 16 bytes")


def paged_attention(q, k_pool, v_pool, tables, ctx_len):
    """One query token per row against the row's block run in the paged pool.

    q: (B, H, hd); k_pool/v_pool: (NB, block_size, KV, hd), e.g. the view
    ``arena.k[layer]``; tables: (B, MAXB) int32, 0-padded; ctx_len: (B,)
    int32.  Returns (B, H, hd) in ``q.dtype``.

    Precondition: ``ctx_len >= 1`` and every live table entry is a block id
    below NB.  Neither is checked (that would synchronise); the serving
    engine passes ``positions + 1``.  A row with an all-zero table and
    ``ctx_len == 1`` reads the dummy block 0.
    """
    check_args(q, k_pool, v_pool, tables, ctx_len)
    if q.device.type == "cpu":
        return paged_attention_plain(q, k_pool, v_pool, tables, ctx_len)
    if q.device.type != "cuda":
        raise RuntimeError(f"no paged attention kernel for {q.device}")
    fn = _launcher()
    b, h, hd = q.shape
    _, bs, kv, _ = k_pool.shape
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
                tables.data_ptr(), ctx_len.data_ptr(), out.data_ptr(),
                b, h, kv, hd, bs, tables.shape[1], _DTYPE_CODE[q.dtype],
                1.0 / math.sqrt(hd), stream)
    if rc != 0:
        raise RuntimeError(
            f"paged_attention_launch failed with code {rc} for q "
            f"{tuple(q.shape)} {q.dtype}, pool {tuple(k_pool.shape)}")
    paged_attention.launches += 1
    return out


paged_attention.launches = 0


def _launcher():
    fn = _build.load("paged_attention").paged_attention_launch
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 7
                       + [ctypes.c_float, ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def live_bytes(ctx_len, block_size: int, n_heads: int, n_kv: int, hd: int,
               itemsize: int) -> int:
    """Bytes the function must move for these rows: the K and V rows of the
    valid tokens, q, the live table entries and ``ctx_len`` read once, the
    output written once."""
    rows = [int(c) for c in ctx_len]
    kv_bytes = sum(rows) * n_kv * hd * 2 * itemsize
    qo_bytes = 2 * len(rows) * n_heads * hd * itemsize
    index_bytes = 4 * (sum(-(-c // block_size) for c in rows) + len(rows))
    return kv_bytes + qo_bytes + index_bytes


def bound_ms(ctx_len, block_size: int, n_heads: int, n_kv: int, hd: int,
             itemsize: int) -> float:
    """Least time an H100 could take for these rows: :func:`live_bytes` over
    the card's memory rate."""
    return 1e3 * live_bytes(ctx_len, block_size, n_heads, n_kv, hd,
                            itemsize) / HBM_BW
