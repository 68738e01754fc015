"""Dense ring-cache decode attention: the CUDA kernel's wrapper and its plain
version.

Counterpart of ``src/repro/kernels/decode_attention.py``
(``decode_attention``, the Pallas TPU kernel) and of
``src/repro/kernels/ref.py`` (``decode_attention_ref``, here
:func:`decode_attention_plain`).

Source note.  ``csrc/decode_attention.cu`` replaces the Pallas kernel
``repro/kernels/decode_attention.py::decode_attention``.  On an H100 the
function is bound by bytes: the K and V rows of the occupied slots
(``pos >= 0``) are read once and each is used for about one operation per
byte, so the least time is ``(n_valid * B * KV * hd * 2 * itemsize + q + out
+ pos) / 3.35 TB/s`` (:func:`bound_ms`).  The first design (tiles staged as
fp32 and folded in three barrier-separated phases) had no load in flight
while a tile was computed and read q and K from shared memory for every
multiply-add.  The design now (``csrc/decode_tile.cuh``): one block per
(sequence, kv head) stages its tiles in their stored type with ``cp.async``
into a ring of three, skipping empty slots, and folds them with the
queries, the softmax state and the accumulators in registers.  The keys are
not split over blocks: at B 32 one block a row beat every split count on
the H100 (``PERF.md`` §5).  The caches are read in their native
``(B, S, KV, hd)`` layout (the TPU wrapper transposed both on every call).

A CUDA tensor goes to the kernel or raises; only a CPU tensor takes the plain
version.  ``decode_attention.launches`` counts kernel launches.
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


def decode_attention_plain(q, k_cache, v_cache, pos):
    """Masked attention in fp32, then cast to ``q.dtype``.  q (B, H, hd);
    caches (B, S, KV, hd); pos (S,) absolute positions, -1 where empty.
    Empty slots' V rows are zeroed, so a row with no occupied slot gives 0
    (the reference's oracle averages V there, the reference's kernel gives 0;
    nothing feeds such a row)."""
    b, h, hd = q.shape
    kv = k_cache.shape[2]
    g = h // kv
    qg = q.reshape(b, kv, g, hd).float() / math.sqrt(hd)
    scores = torch.einsum("bkgd,bskd->bkgs", qg, k_cache.float())
    valid = pos >= 0
    scores = torch.where(valid, scores, torch.full_like(scores, NEG_INF))
    w = torch.softmax(scores, dim=-1)
    vf = torch.where(valid[None, :, None, None], v_cache.float(),
                     torch.zeros((), dtype=torch.float32, device=q.device))
    out = torch.einsum("bkgs,bskd->bkgd", w, vf)
    return out.reshape(b, h, hd).to(q.dtype)


def check_args(q, k_cache, v_cache, pos) -> None:
    """Raise on anything the CUDA kernel cannot address, for a tensor on any
    device.  Touches no data, so it never synchronises."""
    if q.dim() != 3 or k_cache.dim() != 4:
        raise ValueError(f"q must be (B, H, hd) and caches (B, S, KV, hd); "
                         f"got {tuple(q.shape)}, {tuple(k_cache.shape)}")
    b, h, hd = q.shape
    cb, s, kv, chd = k_cache.shape
    if v_cache.shape != k_cache.shape:
        raise ValueError("k_cache and v_cache differ in shape")
    if cb != b or chd != hd:
        raise ValueError(f"caches {tuple(k_cache.shape)} do not fit q "
                         f"{tuple(q.shape)}")
    if hd not in SUPPORTED_HEAD_DIMS:
        raise ValueError(f"head_dim {hd} not supported: the kernel is built "
                         f"for {SUPPORTED_HEAD_DIMS}")
    if kv < 1 or h % kv:
        raise ValueError(f"n_heads {h} is not a multiple of n_kv_heads {kv}")
    if pos.shape != (s,):
        raise ValueError(f"pos must be (S,) = ({s},), got {tuple(pos.shape)}")
    if pos.dtype != torch.int32:
        raise TypeError("pos must be int32")
    if q.dtype not in _DTYPE_CODE:
        raise TypeError(f"dtype {q.dtype} not supported (float32, bfloat16)")
    if k_cache.dtype != q.dtype or v_cache.dtype != q.dtype:
        raise TypeError("q, k_cache and v_cache must share one dtype")
    for name, t in (("q", q), ("k_cache", k_cache), ("v_cache", v_cache),
                    ("pos", pos)):
        if t.device != q.device:
            raise ValueError(f"{name} lies on {t.device}, q on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} is not contiguous: the kernel addresses "
                             f"the caches in their (B, S, KV, hd) layout")
    for name, t in (("q", q), ("k_cache", k_cache), ("v_cache", v_cache)):
        if t.data_ptr() % 16:
            raise ValueError(f"{name} is not aligned to 16 bytes")


def decode_attention(q, k_cache, v_cache, pos, *, block_k: int = 256):
    """One query token per row against a dense (ring) cache.  q (B, H, hd);
    k_cache, v_cache (B, S, KV, hd); pos (S,) int32, -1 where a slot is
    empty.  Returns (B, H, hd) in ``q.dtype``.  ``block_k`` is the
    reference's tiling hint and cannot change the result: the kernel sizes
    its own tiles (``decode_tile.cuh::tile_rows``)."""
    del block_k
    check_args(q, k_cache, v_cache, pos)
    if q.device.type == "cpu":
        return decode_attention_plain(q, k_cache, v_cache, pos)
    if q.device.type != "cuda":
        raise RuntimeError(f"no decode_attention kernel for {q.device}")
    fn = _launcher()
    b, h, hd = q.shape
    s, kv = k_cache.shape[1], k_cache.shape[2]
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
                pos.data_ptr(), out.data_ptr(), b, h, kv, hd, s,
                _DTYPE_CODE[q.dtype], 1.0 / math.sqrt(hd), stream)
    if rc != 0:
        raise RuntimeError(
            f"decode_attention_launch failed with code {rc} for q "
            f"{tuple(q.shape)} {q.dtype}, caches {tuple(k_cache.shape)}")
    decode_attention.launches += 1
    return out


decode_attention.launches = 0


def _launcher():
    fn = _build.load("decode_attention").decode_attention_launch
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 6
                       + [ctypes.c_float, ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def live_bytes(n_valid: int, b: int, h: int, kv: int, s: int, hd: int,
               itemsize: int) -> int:
    """Bytes the function must move: the K and V rows of the ``n_valid``
    occupied slots, q, the output and ``pos``, each once."""
    return (itemsize * hd * (2 * n_valid * b * kv + 2 * b * h)) + 4 * s


def bound_ms(n_valid: int, b: int, h: int, kv: int, s: int, hd: int,
             itemsize: int) -> float:
    """Least time an H100 could take: :func:`live_bytes` over the card's
    memory rate (the ``4 * hd`` operations per valid slot and head are far
    below what the card does in that time)."""
    return 1e3 * live_bytes(n_valid, b, h, kv, s, hd, itemsize) / HBM_BW
