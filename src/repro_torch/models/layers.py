"""Shared layers: RMSNorm, RoPE, GQA attention (full / decode-with-cache /
paged decode), SwiGLU.

Counterpart of ``src/repro/models/layers.py``; plain functions on tensors.
Left for later slices, each raising ``NotImplementedError`` where a caller
could reach it: M-RoPE (3-D positions) in :func:`rope_angles`, the
sliding-window ring placements of :meth:`KVCache.from_prefill`, and
``gqa_attention_qchunk``.

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
    """positions: (B, S) integer.  Returns (B, S, rot_dim // 2) fp32 angles."""
    if positions.dim() != 2 or sections:
        raise NotImplementedError(
            "M-RoPE ((3, B, S) positions with sections) is not ported yet: it "
            "comes with the M-RoPE / embeds-input slice")
    half = rot_dim // 2
    exponent = torch.arange(0, half, dtype=torch.float32,
                            device=positions.device) / half
    inv_freq = 1.0 / (theta ** exponent)
    return positions.float()[..., None] * inv_freq


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


def gqa_attention_qchunk(*args, **kwargs):
    raise NotImplementedError(
        "attn_impl='qchunk' is not ported yet: it comes with the slice of "
        "the remaining pure-attn configs (no config uses it)")


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
        """Build a cache from prefill-computed k/v (B, S, KV, hd), with
        ``reserve`` extra empty slots so that later decode positions never
        wrap the ring."""
        if window:
            raise NotImplementedError(
                "sliding-window cache placement is not ported yet: it comes "
                "with the 'swa' blocks in the MoE/Hymba/xLSTM blocks slice")
        s = k.shape[1]
        pos = torch.arange(s, dtype=torch.int32, device=k.device)
        if reserve:
            k = F.pad(k, (0, 0, 0, 0, 0, reserve))
            v = F.pad(v, (0, 0, 0, 0, 0, reserve))
            pos = F.pad(pos, (0, reserve), value=-1)
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
                                 block_size: int):
    """Gather-then-attend paged decode: one query token per row against the
    row's block run.  Writes the step's K/V into ``tables[row, pos // bs]``
    slot ``pos % bs`` (in place), gathers each row's run into a dense (B, MAXB*bs) view, and runs the
    same :func:`gqa_attention` as the dense ring path, positions ``> pos``
    masked.

    q = (q_new, k_new, v_new), each (B, 1, ., hd); tables (B, MAXB) int32;
    positions (B,) int32 absolute write position per row."""
    q_new, k_new, v_new = q
    b = k_new.shape[0]
    paged_write(paged, k_new, v_new,
                *paged_write_index(tables, positions, block_size))
    maxb = tables.shape[1]
    flat = tables.reshape(-1)
    kg = paged.k.index_select(0, flat).reshape(b, maxb * block_size,
                                               *paged.k.shape[2:])
    vg = paged.v.index_select(0, flat).reshape(b, maxb * block_size,
                                               *paged.v.shape[2:])
    valid = (torch.arange(maxb * block_size, dtype=torch.int32,
                          device=tables.device)[None, :] <= positions[:, None])
    out = gqa_attention(q_new, kg, vg, valid[:, None, None, None, :])
    return out, paged


# -------------------------------------------------------------------- SwiGLU
def swiglu(x, w_gate, w_up, w_down):
    h = F.silu(x @ w_gate) * (x @ w_up)
    return h @ w_down
