"""Block kinds and layer stacks.

Counterpart of ``src/repro/models/blocks.py``.  Ported: kind ``attn`` (full
causal attention + SwiGLU FFN) in all five modes (``train``, ``prefill``,
``decode``, ``prefill_cont``, ``decode_paged``).  Every other kind (``swa``,
``moe``, ``moe_swa``, ``hymba_g``, ``hymba_l``, ``mlstm``, ``slstm``, ``enc``,
``xdec``) and ``attn_impl="qchunk"`` raise ``NotImplementedError`` naming the
slice that brings them.  Activation rematerialisation (``cfg.remat``) belongs
to training and is not read here.

A stack of ``n`` layers keeps its parameters stacked with a leading layer dim,
as the reference does; where the reference scans over that dim, the port runs
a Python loop.  All kinds share one signature::

    apply_block(kind, cfg, p, x, ctx, cache, mode) -> (x', cache')

``ctx`` carries the rope angles, the scalar decode position (a Python int)
and, for paged decode, the block tables and per-row positions.  Decode modes
update their cache in place and return the same object.
"""
from __future__ import annotations

import math
from typing import Any

import torch

from .config import ModelConfig
from .layers import (KVCache, PagedKV, apply_rope, causal_mask, dtype_of,
                     gqa_attention, gqa_attention_bf16, gqa_attention_qchunk,
                     paged_decode_attention_dense, paged_write,
                     paged_write_index, rms_norm, stacked_dense_init, swiglu)

_LATER = {
    "swa": "the MoE/Hymba/xLSTM blocks slice",
    "moe": "the MoE/Hymba/xLSTM blocks slice",
    "moe_swa": "the MoE/Hymba/xLSTM blocks slice",
    "hymba_g": "the MoE/Hymba/xLSTM blocks slice",
    "hymba_l": "the MoE/Hymba/xLSTM blocks slice",
    "mlstm": "the MoE/Hymba/xLSTM blocks slice",
    "slstm": "the MoE/Hymba/xLSTM blocks slice",
    "enc": "the encoder-decoder slice",
    "xdec": "the encoder-decoder slice",
}


def _require_attn(kind: str) -> None:
    if kind == "attn":
        return
    if kind in _LATER:
        raise NotImplementedError(
            f"block kind {kind!r} is not ported to repro_torch yet: it comes "
            f"with {_LATER[kind]}")
    raise ValueError(f"unknown block kind {kind}")


# --------------------------------------------------------------------- init
def init_stack(gen: torch.Generator, kind: str, n: int, cfg: ModelConfig,
               device) -> dict[str, Any]:
    """Parameters of ``n`` stacked layers of ``kind``: the reference's names
    and ``(d_in, d_out)`` layouts with a leading layer dim, ``ffn`` nested."""
    _require_attn(kind)
    dtype = dtype_of(cfg.dtype)
    d, h, kv, hd, f = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd, cfg.d_ff
    depth_scale = 1.0 / math.sqrt(2.0 * max(cfg.decoder_layers(), 1))

    def dense(d_in, d_out, scale=1.0):
        return stacked_dense_init(gen, n, d_in, d_out, dtype, device, scale)

    def zeros():
        return torch.zeros((n, d), dtype=torch.float32, device=device)

    return {
        "norm1": zeros(),
        "wq": dense(d, h * hd), "wk": dense(d, kv * hd),
        "wv": dense(d, kv * hd), "wo": dense(h * hd, d, depth_scale),
        "norm2": zeros(),
        "ffn": {"w_gate": dense(d, f), "w_up": dense(d, f),
                "w_down": dense(f, d, depth_scale)},
    }


def init_block(gen: torch.Generator, kind: str, cfg: ModelConfig, device):
    """Parameters of one layer (no leading dim)."""
    return layer_params(init_stack(gen, kind, 1, cfg, device), 0)


def layer_params(stack: dict, i: int) -> dict:
    """View of layer ``i`` of a stacked-parameter dict (no copy)."""
    return {k: (layer_params(v, i) if isinstance(v, dict) else v[i])
            for k, v in stack.items()}


# ------------------------------------------------------------------- caches
def init_block_cache(kind: str, cfg: ModelConfig, batch: int, cache_len: int,
                     enc_len: int = 0, device=None):
    """Cache for ONE layer of ``kind``."""
    _require_attn(kind)
    return KVCache.init(batch, cache_len, cfg.n_kv_heads, cfg.hd,
                        dtype_of(cfg.dtype), device)


# ---------------------------------------------------------------- attention
def _qkv(p, x, cfg: ModelConfig, angles):
    b, s, _ = x.shape
    h, kv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    q = (x @ p["wq"]).reshape(b, s, h, hd)
    k = (x @ p["wk"]).reshape(b, s, kv, hd)
    v = (x @ p["wv"]).reshape(b, s, kv, hd)
    if angles is not None:
        q = apply_rope(q, angles)
        k = apply_rope(k, angles)
    return q, k, v


def _attn_fn(cfg: ModelConfig):
    if cfg.attn_impl == "qchunk":
        gqa_attention_qchunk()              # raises: not ported yet
    return gqa_attention_bf16 if cfg.attn_impl == "bf16" else gqa_attention


def _attn_seq(p, x, cfg, angles):
    q, k, v = _qkv(p, x, cfg, angles)
    s = x.shape[1]
    out = _attn_fn(cfg)(q, k, v, causal_mask(s, s, device=x.device))
    return out.reshape(*x.shape[:2], -1) @ p["wo"], (k, v)


def _attn_decode(p, x, cfg, angles, cache: KVCache, position: int):
    q, k, v = _qkv(p, x, cfg, angles)
    cache = cache.update(k, v, position)
    out = gqa_attention(q, cache.k, cache.v, cache.decode_mask())
    return out.reshape(*x.shape[:2], -1) @ p["wo"], cache


def _attn_decode_paged(p, x, cfg, angles, cache: PagedKV, ctx):
    """One decode token per row against the row's block run in the paged KV
    pool, each row at its OWN absolute position.  The default dense path
    equals :func:`_attn_decode` per row; ``ctx["paged_impl"] == "kernel"``
    runs the CUDA paged attention kernel over the block tables (allclose, not
    bitwise: the engine's deployment switch)."""
    qkv = _qkv(p, x, cfg, angles)
    if ctx.get("paged_impl", "dense") == "kernel":
        out, cache = _paged_decode_kernel(qkv, cache, ctx)
    else:
        out, cache = paged_decode_attention_dense(
            qkv, cache, ctx["paged_tables"], ctx["paged_positions"],
            ctx["paged_block_size"])
    return out.reshape(*x.shape[:2], -1) @ p["wo"], cache


def _paged_decode_kernel(qkv, paged: PagedKV, ctx):
    """Kernel decode step: write the new token's K/V into the pool (the same
    scatter as the dense path), then attend through the block table with
    kernels.ops.paged_decode_attention.  Valid context length per row is
    position + 1 (the token just written).  The write index and the context
    lengths are the same for every layer of a step, so they are computed once
    and kept in ``ctx``."""
    from ..kernels.ops import paged_decode_attention
    q_new, k_new, v_new = qkv
    tables = ctx["paged_tables"]
    if "paged_write_index" not in ctx:
        ctx["paged_write_index"] = paged_write_index(
            tables, ctx["paged_positions"], ctx["paged_block_size"])
        ctx["paged_ctx_len"] = (ctx["paged_positions"] + 1).to(torch.int32)
    paged_write(paged, k_new, v_new, *ctx["paged_write_index"])
    out = paged_decode_attention(q_new[:, 0], paged.k, paged.v, tables,
                                 ctx["paged_ctx_len"])
    return out[:, None], paged


def _attn_cont(p, x, cfg, angles, cache: KVCache, reserve: int = 0):
    """Continued (chunked) prefill over prepended cached KV, the prefix-KV
    reuse path: the new tokens' queries attend causally over
    ``[cached KV; own KV]`` with absolute query offset = cached length.
    Cached KV may be batch-1 (a shared prefix broadcast over the batch).
    Full attention, einsum/bf16 impls only."""
    fn = _attn_fn(cfg)
    q, k, v = _qkv(p, x, cfg, angles)
    b, s = x.shape[:2]
    start = cache.k.shape[1]
    kc, vc = cache.k, cache.v
    if kc.shape[0] != b:
        kc = kc.expand(b, *kc.shape[1:])
        vc = vc.expand(b, *vc.shape[1:])
    k_all = torch.cat([kc, k], dim=1)
    v_all = torch.cat([vc, v], dim=1)
    mask = causal_mask(s, start + s, 0, q_offset=start, device=x.device)
    out = fn(q, k_all, v_all, mask)
    return (out.reshape(b, s, -1) @ p["wo"],
            KVCache.from_prefill(k_all, v_all, 0, reserve))


# ------------------------------------------------------------------- apply
def apply_block(kind: str, cfg: ModelConfig, p, x, ctx, cache, mode: str):
    if mode in ("prefill_cont", "decode_paged") and kind != "attn":
        raise NotImplementedError(
            f"{mode} (paged/prefix KV reuse) supports pure full-attention "
            f"'attn' stacks only, got {kind!r}")
    _require_attn(kind)
    rs = cfg.residual_scale
    eps = cfg.norm_eps
    angles = ctx.get("angles")
    new_cache = cache
    h = rms_norm(x, p["norm1"], eps)
    if mode == "decode":
        a, new_cache = _attn_decode(p, h, cfg, angles, cache, ctx["position"])
    elif mode == "decode_paged":
        a, new_cache = _attn_decode_paged(p, h, cfg, angles, cache, ctx)
    elif mode == "prefill_cont":
        a, new_cache = _attn_cont(p, h, cfg, angles, cache,
                                  ctx.get("reserve", 0))
    elif mode in ("train", "prefill"):
        a, (k, v) = _attn_seq(p, h, cfg, angles)
        if mode == "prefill":
            new_cache = KVCache.from_prefill(k, v, 0, ctx.get("reserve", 0))
    else:
        raise ValueError(f"unknown mode {mode}")
    x = x + rs * a
    h = rms_norm(x, p["norm2"], eps)
    x = x + rs * swiglu(h, **p["ffn"])
    return x, new_cache


# ------------------------------------------------------------------- stacks
def _layer_cache(cache, i: int):
    return type(cache)(*(leaf[i] for leaf in cache))


def apply_stack(kind: str, cfg: ModelConfig, stack, x, ctx, cache=None,
                mode: str = "train"):
    """Run ``apply_block`` over the layers of a stacked-parameter stack.

    cache: stacked (leading dim n) KVCache / PagedKV, or None.  Returns
    (x, cache): for ``prefill`` and ``prefill_cont`` a newly stacked KVCache,
    for ``decode`` and ``decode_paged`` the cache passed in, updated in
    place, for ``train`` None.
    """
    n = stack["norm1"].shape[0]
    emitted = []
    for i in range(n):
        c = _layer_cache(cache, i) if cache is not None else None
        x, c2 = apply_block(kind, cfg, layer_params(stack, i), x, ctx, c, mode)
        if mode in ("prefill", "prefill_cont"):
            emitted.append(c2)
    if emitted:
        return x, KVCache(*(torch.stack(leaves) for leaves in zip(*emitted)))
    return x, (cache if mode in ("decode", "decode_paged") else None)
