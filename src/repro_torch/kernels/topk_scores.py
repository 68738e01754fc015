"""Blocked top-k of a score vector: the CUDA kernel's wrapper and its plain
version.

Counterpart of ``src/repro/kernels/topk_scores.py`` (``topk_scores``, the
Pallas TPU kernel that gives each block's top k) together with the final
``lax.top_k`` over the candidates in ``src/repro/kernels/ops.py``
(``topk_scores``): this module computes the whole function of the
reference's ``ops.topk_scores``.

Source note.  ``csrc/topk_scores.cu`` replaces the Pallas kernel
``repro/kernels/topk_scores.py::topk_scores`` and the ``lax.top_k`` after it.
Stage 1 runs one thread block per tile of ``bn`` slots (:func:`tile_size`, the
reference's rule): a radix select in shared memory finds the tile's best k
(rank, slot) pairs, sorts only those, and writes the k candidates that k
rounds of arg-max and mask would give (the lower index wins a tie, as
``jnp.argmax``), the rounds past the tile's scores above ``NEG_INF`` in closed
form.  Stage 2 keeps the k best candidates in (value descending, position
ascending) order, which is ``lax.top_k``'s, by the same select: one block when
there are at most 4096 candidates, else a grid of blocks over runs of them and
one block over their survivors.  A NaN ranks above every number in both
stages, as in ``jnp.argmax`` and ``torch.sort``; a NaN with its sign bit set
does too, where the reference's ``lax.top_k`` on the CPU puts it last.  Bound
by bytes: each score is read once (:func:`bound_ms`).

The reference's padding is kept: slots past N hold ``NEG_INF = -3e38``, which
outranks a score of ``-inf``, and a masked winner holds ``-3e38`` again.  So
with ``-inf`` scores the indices differ from ``ref.topk_ref`` exactly as the
reference's do.

A CUDA tensor goes to the kernel or raises; only a CPU tensor takes the plain
version.  ``topk_scores.launches`` counts kernel launches (one a call, every
stage).
"""
from __future__ import annotations

import ctypes

import torch

from ..launch.mesh import HBM_BW, PEAK_FLOPS_FP32
from . import _build

NEG_INF = -3.0e38                  # the reference's padding and mask value
MAX_BLOCK_N = 8192                 # a tile's sort keys in 64 KB of shared memory
MAX_K = 1024
MERGE_RUN = 2048                   # the least candidates a merge block takes
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def _next_pow2(x: int) -> int:
    return 1 if x <= 1 else 1 << (x - 1).bit_length()


def tile_size(n: int, k: int, block_n: int) -> int:
    """The reference's tile: ``min(block_n, max(k, next_pow2(min(n,
    block_n))))``."""
    return min(block_n, max(k, _next_pow2(min(n, block_n))))


def topk_scores_plain(scores, k: int, *, block_n: int = 1024):
    """scores (N,) -> (values (k,) fp32, indices (k,) int32), computed as
    the reference's ``ops.topk_scores``: per tile, k rounds of arg-max (the
    first index of the maximum, a NaN first) and mask with ``NEG_INF``; then
    a stable descending sort of the candidates (NaNs first), of which the
    first k are kept."""
    n = scores.shape[0]
    bn = tile_size(n, k, block_n)
    nb = -(-n // bn)
    tiles = torch.full((nb * bn,), NEG_INF, dtype=torch.float32, device=scores.device)
    tiles[:n] = scores.float()
    tiles = tiles.view(nb, bn)
    rows = torch.arange(nb, device=scores.device)
    cand_v = torch.empty((nb, k), dtype=torch.float32, device=scores.device)
    cand_i = torch.empty((nb, k), dtype=torch.int64, device=scores.device)
    for j in range(k):
        am = tiles.argmax(dim=1)
        cand_v[:, j] = tiles[rows, am]
        cand_i[:, j] = rows * bn + am
        tiles[rows, am] = NEG_INF
    cand_v, cand_i = cand_v.reshape(-1), cand_i.reshape(-1)
    sel = torch.sort(cand_v, descending=True, stable=True).indices[:k]
    return cand_v[sel], cand_i[sel].int()


def check_args(scores, k: int, block_n: int) -> None:
    """Raise on anything the CUDA kernel cannot take, for a tensor on any
    device.  Touches no data."""
    if scores.dim() != 1 or scores.shape[0] < 1:
        raise ValueError(f"scores must be (N,) with N >= 1, got {tuple(scores.shape)}")
    if not scores.dtype.is_floating_point:
        raise TypeError(f"scores must be floating point, got {scores.dtype}")
    if not 1 <= k <= MAX_K:
        raise ValueError(f"k = {k} must lie in 1..{MAX_K}")
    if block_n < 1:
        raise ValueError(f"block_n = {block_n} must be >= 1")
    n = scores.shape[0]
    bn = tile_size(n, k, block_n)
    if bn > MAX_BLOCK_N:
        raise ValueError(f"tile of {bn} slots: the kernel takes at most {MAX_BLOCK_N}")
    if -(-n // bn) * k >= 2 ** 31:
        raise ValueError(f"{-(-n // bn) * k} candidates do not fit int32 positions")
    if not scores.is_contiguous():
        raise ValueError("scores is not contiguous")


def topk_scores(scores, k: int, *, block_n: int = 1024):
    """scores (N,) any float -> (values (k,) fp32, indices (k,) int32), the
    k largest largest first, computed in fp32.  A float type other than fp32
    and bf16 is cast to fp32 first, as the reference's kernel casts."""
    check_args(scores, k, block_n)
    if scores.device.type == "cpu":
        return topk_scores_plain(scores, k, block_n=block_n)
    if scores.device.type != "cuda":
        raise RuntimeError(f"no topk_scores kernel for {scores.device}")
    if scores.dtype not in _DTYPE_CODE:
        scores = scores.float()
    fn = _launcher()
    n = scores.shape[0]
    bn = tile_size(n, k, block_n)
    m = -(-n // bn) * k
    dev = scores.device
    # candidates' sort keys, the merge blocks' survivors, values and indices
    scratch = torch.empty((2 * m + -(-m // MERGE_RUN) * k,), dtype=torch.int64, device=dev)
    vals = torch.empty((k,), dtype=torch.float32, device=dev)
    idx = torch.empty((k,), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(scores.data_ptr(), n, k, bn, scratch.data_ptr(), vals.data_ptr(),
                idx.data_ptr(), _DTYPE_CODE[scores.dtype], stream)
    if rc != 0:
        raise RuntimeError(f"topk_scores_launch failed with code {rc} for scores "
                           f"{tuple(scores.shape)} {scores.dtype}, k {k}, tile {bn}")
    topk_scores.launches += 1
    return vals, idx


topk_scores.launches = 0


def _launcher():
    fn = _build.load("topk_scores").topk_scores_launch
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] + [ctypes.c_int] * 3 + [ctypes.c_void_p] * 3
                       + [ctypes.c_int, ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def live_bytes(n: int, k: int, itemsize: int) -> int:
    """Bytes the function must move: each score once, the k values and
    indices once."""
    return n * itemsize + k * 8


def operations(n: int, k: int, block_n: int) -> int:
    """The compares top-k needs whatever the design: one per score, then
    one per candidate of the ``n_blocks * k`` that the tiles hand on."""
    return n + -(-n // tile_size(n, k, block_n)) * k


def bound_ms(n: int, k: int, itemsize: int, block_n: int = 1024):
    """Least time an H100 could take: the larger of :func:`live_bytes` over
    the memory rate and :func:`operations` over the fp32 peak.  Returns
    ``(ms, "bytes" | "operations")``."""
    return max((1e3 * live_bytes(n, k, itemsize) / HBM_BW, "bytes"),
               (1e3 * operations(n, k, block_n) / PEAK_FLOPS_FP32, "operations"))
