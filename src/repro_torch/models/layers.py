"""Shared layers: RMSNorm, RoPE / M-RoPE, GQA attention (full / query-blocked
/ cross / decode-with-cache / paged decode), SwiGLU.

Counterpart of ``src/repro/models/layers.py``; plain functions on tensors.

Conventions (as in the reference): activations in the config's dtype, softmax
and norms in fp32; caches are rings with ``slot = position % cache_len`` and an
absolute-position array ``pos`` per slot (-1 = empty); shapes (B, S, ...),
heads split as (B, S, n_heads, head_dim).

Where the reference builds a new array with ``.at[].set`` and relies on buffer
donation, the port updates in place: :meth:`KVCache.update` and
:func:`paged_decode_attention_dense` write into the tensors they are given and
return them.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.nn.functional as F

NEG_INF = -1e30


def dtype_of(name: str) -> torch.dtype:
    return {"bfloat16": torch.bfloat16, "float32": torch.float32}[name]


# ------------------------------------------------------- tensor-parallel heads
class HeadSpan(NamedTuple):
    """The heads one process computes under a ``model`` cut that may fall
    inside a head.  Its output projection holds rows ``[lo, lo + cols)`` of
    the flattened ``n_heads * hd`` (``param_specs`` cuts them in equal
    parts); it computes q heads ``[h0, h0 + nq)``, the whole heads those
    rows read, over kv heads ``[kv0, kv0 + nkv)``, and keeps columns
    ``[col0, col0 + cols)`` of their flattened output."""
    h0: int
    nq: int
    kv0: int
    nkv: int
    col0: int
    cols: int

    def grouped(self, group: int) -> bool:
        """The q heads are whole kv groups, so GQA's grouping holds as it
        is."""
        return self.h0 == self.kv0 * group and self.nq == self.nkv * group


def head_span(n_heads: int, n_kv: int, hd: int, rows: int, rank: int) -> HeadSpan:
    """:class:`HeadSpan` of the process at ``rank`` on the model axis, whose
    output projection holds ``rows`` of the ``n_heads * hd`` input rows (all
    of them when the cut does not divide)."""
    full = n_heads * hd
    if rows == full:
        return HeadSpan(0, n_heads, 0, n_kv, 0, full)
    lo = rank * rows
    h0, h1 = lo // hd, -(-(lo + rows) // hd)
    group = n_heads // n_kv
    kv0, kv1 = h0 // group, -(-h1 // group)
    return HeadSpan(h0, h1 - h0, kv0, kv1 - kv0, lo - h0 * hd, rows)


def cut_rows(full: int, model: int) -> int:
    """The rows of a ``full``-row leaf one process holds when ``param_specs``
    cuts it over a model axis of ``model`` (whole when it does not divide)."""
    return full // model if full % model == 0 else full


def rolled(x) -> bool:
    """Whether a recurrence over ``x`` runs one trip of its loop and repeats
    that trip's output for the others: on ``meta`` tensors, the dry-run's
    abstract model, where every trip has the same ops on the same shapes.
    The reference's cost analysis counts a rolled scan's body once the same
    way, and ``launch.roofline.inner_scan_flop_correction`` adds the other
    trips' matmul FLOPs."""
    return x.device.type == "meta"


# --------------------------------------------------------------- init helpers
def stacked_dense_init(gen: torch.Generator, n: int, d_in: int, d_out: int,
                       dtype, device, scale: float = 1.0):
    """(n, d_in, d_out) normal weights with std ``scale / sqrt(d_in)``, drawn
    in fp32 from ``gen`` (which must live on ``device``) and cast."""
    std = scale / math.sqrt(d_in)
    w = torch.randn((n, d_in, d_out), generator=gen, device=device,
                    dtype=torch.float32)
    return (w * std).to(dtype)


# --------------------------------------------------------------------- norms
def rms_norm(x, scale, eps: float = 1e-5):
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps)
    return (out * (1.0 + scale.float())).to(x.dtype)


# ---------------------------------------------------------------------- RoPE
def rope_angles(positions, rot_dim: int, theta: float, sections=()):
    """positions: (B, S) integer, or (3, B, S) for M-RoPE with ``sections``
    (t, h, w) frequency-group sizes summing to rot_dim // 2: frequency ``j``
    of group ``i`` turns with position row ``i``.  Returns (B, S,
    rot_dim // 2) fp32 angles."""
    half = rot_dim // 2
    exponent = torch.arange(0, half, dtype=torch.float32,
                            device=positions.device) / half
    inv_freq = 1.0 / (theta ** exponent)
    if positions.dim() == 2:
        return positions.float()[..., None] * inv_freq
    if positions.dim() != 3 or not sections:
        raise ValueError("M-RoPE needs (3, B, S) positions and sections, got "
                         f"positions {tuple(positions.shape)}, sections {sections!r}")
    sec_ids = torch.cat([torch.full((n,), i, dtype=torch.long, device=positions.device)
                         for i, n in enumerate(sections)])          # (half,)
    pos = positions.index_select(0, sec_ids)                        # (half, B, S)
    return pos.movedim(0, -1).float() * inv_freq


def apply_rope(x, angles):
    """x: (B, S, N, hd); angles: (B, S, hd // 2).  Half-split layout; cos and
    sin are cast to ``x.dtype`` before the multiply."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    cos = torch.cos(angles)[:, :, None, :].to(x.dtype)
    sin = torch.sin(angles)[:, :, None, :].to(x.dtype)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


# ----------------------------------------------------------------- attention
def gqa_attention(q, k, v, mask):
    """Reference attention: q (B, Sq, H, hd); k, v (B, Sk, KV, hd); mask
    broadcastable to (B, KV, G, Sq, Sk).  Scores are the product in the
    working dtype, then fp32 for scale, mask and softmax; the weights are cast
    to ``v.dtype`` for the second product."""
    b, sq, h, hd = q.shape
    kv = k.shape[2]
    g = h // kv
    qg = q.reshape(b, sq, kv, g, hd)
    scores = torch.einsum("bqkgd,bskd->bkgqs", qg, k).float()
    scores = scores / math.sqrt(hd)
    scores = scores.masked_fill(~mask, NEG_INF)
    w = torch.softmax(scores, dim=-1).to(v.dtype)
    out = torch.einsum("bkgqs,bskd->bqkgd", w, v)
    return out.reshape(b, sq, h, hd)


def gqa_attention_bf16(q, k, v, mask):
    """Scores and softmax stored in the working dtype end to end."""
    b, sq, h, hd = q.shape
    kv = k.shape[2]
    g = h // kv
    qg = (q / math.sqrt(hd)).reshape(b, sq, kv, g, hd)
    scores = torch.einsum("bqkgd,bskd->bkgqs", qg, k)
    scores = scores.masked_fill(~mask, -3e38)
    w = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgqs,bskd->bqkgd", w, v)
    return out.reshape(b, sq, h, hd)


def gqa_attention_qchunk(q, k, v, *, causal: bool, window: int,
                         chunk: int = 512):
    """Query blocking in plain PyTorch, the reference's XLA scan as a loop:
    the score transient is (c, Sk), not (Sq, Sk), with ``c`` the largest
    divisor of Sq that is at most ``chunk``.  q is pre-scaled by
    1/sqrt(hd); scores and softmax stay in the working dtype.  With a window
    each block attends only its live KV range of ``window + c`` columns.
    Self-attention only (Sq == Sk)."""
    b, sq, h, hd = q.shape
    kv = k.shape[2]
    g = h // kv
    c = min(chunk, sq)
    while sq % c:
        c -= 1
    qg = (q / math.sqrt(hd)).reshape(b, sq, kv, g, hd)
    wlen = min(sq, window + c) if window else sq
    fill = -3e38 if q.dtype == torch.bfloat16 else NEG_INF
    rows_base = torch.arange(c, device=q.device)
    outs = []
    for qi in range(sq // c):
        rows = qi * c + rows_base                         # absolute q rows
        start = min(max(qi * c + c - wlen, 0), sq - wlen)
        ks, vs = k[:, start:start + wlen], v[:, start:start + wlen]
        cols = start + torch.arange(wlen, device=q.device)  # absolute kv cols
        m = torch.ones((c, wlen), dtype=torch.bool, device=q.device)
        if causal:
            m &= cols[None, :] <= rows[:, None]
        if window:
            m &= cols[None, :] > rows[:, None] - window
        scores = torch.einsum("bqkgd,bskd->bkgqs", qg[:, qi * c:(qi + 1) * c], ks)
        w = torch.softmax(scores.masked_fill(~m, fill), dim=-1)
        outs.append(torch.einsum("bkgqs,bskd->bqkgd", w, vs))
    return torch.cat(outs, dim=1).reshape(b, sq, h, hd)


def causal_mask(sq: int, sk: int, window: int = 0, q_offset: int = 0,
                device=None):
    """(1, 1, 1, sq, sk) bool; window=0 => unbounded causal."""
    qi = torch.arange(sq, device=device)[:, None] + q_offset
    kj = torch.arange(sk, device=device)[None, :]
    m = kj <= qi
    if window:
        m &= kj > qi - window
    return m[None, None, None]


def full_mask(sq: int, sk: int, device=None):
    return torch.ones((1, 1, 1, sq, sk), dtype=torch.bool, device=device)


# ------------------------------------------------------------------ KV cache
class KVCache(NamedTuple):
    """Ring cache.  k/v: (B, S_c, KV, hd); pos: (S_c,) absolute positions,
    -1 where empty.  Full attention uses S_c = max_len (the ring never
    wraps).  Stacked over a layer stack the leaves gain a leading dim."""

    k: torch.Tensor
    v: torch.Tensor
    pos: torch.Tensor

    @staticmethod
    def init(batch: int, cache_len: int, n_kv: int, hd: int, dtype,
             device=None) -> "KVCache":
        return KVCache(
            k=torch.zeros((batch, cache_len, n_kv, hd), dtype=dtype, device=device),
            v=torch.zeros((batch, cache_len, n_kv, hd), dtype=dtype, device=device),
            pos=torch.full((cache_len,), -1, dtype=torch.int32, device=device),
        )

    @staticmethod
    def from_prefill(k, v, window: int = 0, reserve: int = 0) -> "KVCache":
        """Build a cache from prefill-computed k/v (B, S, KV, hd).  Sliding
        window: a ring of ``window`` slots holding the trailing ``window``
        positions at ``slot = position % window`` (``window < S``), or the
        S positions followed by empty slots (``window >= S``).  Full
        attention: ``reserve`` extra empty slots so that later decode
        positions never wrap the ring."""
        b, s = k.shape[:2]
        dev = k.device
        if window and window < s:
            slots = torch.arange(s - window, s, device=dev) % window
            kr = torch.zeros((b, window) + k.shape[2:], dtype=k.dtype, device=dev)
            vr = torch.zeros((b, window) + v.shape[2:], dtype=v.dtype, device=dev)
            kr[:, slots] = k[:, s - window:]
            vr[:, slots] = v[:, s - window:]
            pos = torch.full((window,), -1, dtype=torch.int32, device=dev)
            pos[slots] = torch.arange(s - window, s, dtype=torch.int32, device=dev)
            return KVCache(kr, vr, pos)
        pad = (window - s) if window else reserve
        pos = torch.arange(s, dtype=torch.int32, device=dev)
        if pad:
            k = F.pad(k, (0, 0, 0, 0, 0, pad))
            v = F.pad(v, (0, 0, 0, 0, 0, pad))
            pos = F.pad(pos, (0, pad), value=-1)
        return KVCache(k, v, pos)

    def update(self, k_new, v_new, position: int) -> "KVCache":
        """Insert one token (B, 1, KV, hd) at absolute ``position`` (a Python
        int), in place."""
        slot = int(position) % self.k.shape[1]
        self.k[:, slot] = k_new[:, 0]
        self.v[:, slot] = v_new[:, 0]
        self.pos[slot] = int(position)
        return self

    def decode_mask(self):
        """(1, 1, 1, 1, S_c) validity mask."""
        return (self.pos >= 0)[None, None, None, None, :]


# ------------------------------------------------------------- paged KV pool
class PagedKV(NamedTuple):
    """One layer-stack's slice of the block-paged KV arena (see
    serving/kv_pool.py for the allocator that owns block lifetimes).

    k/v: (num_blocks, block_size, KV, hd) for one layer, with a leading layer
    dim for a stack.  Block 0 is the permanent dummy target of padded
    block-table slots and bucket-dummy rows; it is never allocated, so what
    lands there is never read unmasked.  Block ``i`` of a sequence's table
    holds absolute positions ``[i*block_size, (i+1)*block_size)``."""

    k: torch.Tensor
    v: torch.Tensor


def paged_write_index(tables, positions, block_size: int):
    """(block id, slot) of each row's write position, as int64 index
    tensors."""
    pos = positions.long()
    blk = tables.gather(1, (pos // block_size)[:, None])[:, 0].long()
    return blk, pos % block_size


def paged_write(paged: PagedKV, k_new, v_new, blk, slot) -> None:
    """Scatter one new token per row, (B, 1, KV, hd), into the pool in
    place."""
    paged.k.index_put_((blk, slot), k_new[:, 0])
    paged.v.index_put_((blk, slot), v_new[:, 0])


def paged_decode_attention_dense(q, paged: PagedKV, tables, positions,
                                 block_size: int, attend=None):
    """Gather-then-attend paged decode: one query token per row against the
    row's block run.  Writes the step's K/V into ``tables[row, pos // bs]``
    slot ``pos % bs`` (in place), then :func:`paged_attend_dense`.

    q = (q_new, k_new, v_new), each (B, 1, ., hd); tables (B, MAXB) int32;
    positions (B,) int32 absolute write position per row."""
    q_new, k_new, v_new = q
    paged_write(paged, k_new, v_new,
                *paged_write_index(tables, positions, block_size))
    return paged_attend_dense(q_new, paged, tables, positions, block_size,
                              attend), paged


def paged_attend_dense(q_new, paged: PagedKV, tables, positions,
                       block_size: int, attend=None):
    """The attention half of :func:`paged_decode_attention_dense`: gathers
    each row's run into a dense (B, MAXB*bs) view and runs the same
    :func:`gqa_attention` as the dense ring path (or ``attend``, of the
    same signature), positions ``> pos`` masked."""
    b = q_new.shape[0]
    maxb = tables.shape[1]
    flat = tables.reshape(-1)
    kg = paged.k.index_select(0, flat).reshape(b, maxb * block_size,
                                               *paged.k.shape[2:])
    vg = paged.v.index_select(0, flat).reshape(b, maxb * block_size,
                                               *paged.v.shape[2:])
    valid = (torch.arange(maxb * block_size, dtype=torch.int32,
                          device=tables.device)[None, :] <= positions[:, None])
    return (attend or gqa_attention)(q_new, kg, vg, valid[:, None, None, None, :])


# -------------------------------------------------------------------- SwiGLU
def swiglu(x, w_gate, w_up, w_down):
    h = F.silu(x @ w_gate) * (x @ w_up)
    return h @ w_down
