"""Block kinds and layer stacks.

Counterpart of ``src/repro/models/blocks.py``: kinds ``attn`` (full causal
attention + SwiGLU FFN), ``swa`` (sliding-window attention + FFN), ``moe`` /
``moe_swa`` (full / sliding-window attention + top-k MoE FFN), ``hymba_g`` /
``hymba_l`` (full / sliding-window attention in parallel with Mamba SSM
heads, + FFN), ``mlstm`` and ``slstm`` (xLSTM), ``enc`` (bidirectional
encoder attention + FFN, no cache) and ``xdec`` (decoder self-attention,
cross-attention over the encoder's output, + FFN), in modes ``train``,
``prefill`` and ``decode``; ``prefill_cont`` and ``decode_paged`` for
``attn`` only, as in the reference.  ``attn_impl`` picks the sequence
attention: ``einsum``, ``bf16`` or ``qchunk`` (query-blocked).  In mode
``train`` with gradients on, each layer is rematerialised as ``cfg.remat``
says (:func:`apply_stack`).

On a mesh (the serving engine's ``distributed.context.shard_context``) a
layer gets this process's slice of its parameters and is tensor-parallel in
the Megatron style: ``wq`` / ``wk`` / ``wv`` / ``w_gate`` / ``w_up`` and the
experts' F dim column-split, whole heads only, ``wo`` / ``w_down`` row-split
and their products summed over the ``model`` group.  Head counts are read off
the weights; a product is summed exactly when its contracted dim is smaller
than the config's, so without a mesh nothing changes.  ``moe_impl="sharded"``
dispatches each data shard's own tokens (:func:`~.moe.moe_ffn_sharded`); the
global dispatch of a row-split batch ranks capacity over the whole batch,
gathered over the data axes.

A stack of ``n`` layers keeps its parameters stacked with a leading layer dim,
as the reference does; where the reference scans over that dim, the port runs
a Python loop.  All kinds share one signature::

    apply_block(kind, cfg, p, x, ctx, cache, mode) -> (x', cache')

``ctx`` carries the rope angles (None for a purely recurrent model), the
encoder's output ``enc_out`` (encoder-decoder, every mode but decode), the
scalar decode position (a Python int) and, for paged decode, the block tables
and per-row positions.  A layer's cache is a ``KVCache``, an SSM / mLSTM /
sLSTM state, a tuple of those (Hymba), ``(KVCache, cross K, cross V)``
(``xdec``) or ``()`` (``enc``); a stack's cache has the same structure with
a leading layer dim on every leaf.  :func:`apply_stack` leaves decode-mode
caches updated in place.
"""
from __future__ import annotations

import math
from typing import Any

import torch
from torch.utils.checkpoint import checkpoint

from ..distributed.context import (constrain, get_shard_context, local_rows,
                                   model_sum, pin_rows, rows_gather,
                                   rows_split)
from .config import ModelConfig
from .layers import (KVCache, PagedKV, apply_rope, causal_mask, dtype_of,
                     full_mask, gqa_attention, gqa_attention_bf16,
                     gqa_attention_qchunk,
                     paged_attend_dense, paged_decode_attention_dense,
                     paged_write,
                     paged_write_index, rms_norm, stacked_dense_init, swiglu)
from .moe import init_moe_params, moe_ffn, moe_ffn_sharded
from .ssm import (init_ssm_params, init_ssm_state, ssm_prefill_state,
                  ssm_sequence, ssm_step)
from .xlstm import (init_mlstm_params, init_mlstm_state, init_slstm_params,
                    init_slstm_state, mlstm_sequence, mlstm_step,
                    slstm_sequence, slstm_step)

KINDS = ("attn", "swa", "moe", "moe_swa", "hymba_g", "hymba_l", "mlstm",
         "slstm", "enc", "xdec")
WINDOWED = {"swa", "moe_swa", "hymba_l"}
MODES = ("train", "prefill", "decode", "prefill_cont", "decode_paged")


def _check_kind(kind: str) -> None:
    if kind not in KINDS:
        raise ValueError(f"unknown block kind {kind}")


# --------------------------------------------------------------------- init
def init_stack(gen: torch.Generator, kind: str, n: int, cfg: ModelConfig,
               device) -> dict[str, Any]:
    """Parameters of ``n`` stacked layers of ``kind``: the reference's names
    and ``(d_in, d_out)`` layouts with a leading layer dim; ``ffn``, ``moe``
    and ``ssm`` nested, norm scales fp32."""
    _check_kind(kind)
    dtype = dtype_of(cfg.dtype)
    d, h, kv, hd, f = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd, cfg.d_ff
    depth_scale = 1.0 / math.sqrt(2.0 * max(cfg.decoder_layers(), 1))

    def dense(d_in, d_out, scale=1.0):
        return stacked_dense_init(gen, n, d_in, d_out, dtype, device, scale)

    def zeros():
        return torch.zeros((n, d), dtype=torch.float32, device=device)

    p: dict[str, Any] = {"norm1": zeros()}
    if kind == "mlstm":
        p.update(init_mlstm_params(gen, n, d, h, cfg.qk, hd, dtype, device))
        return p
    if kind == "slstm":
        p.update(init_slstm_params(gen, n, d, h, hd, dtype, device))
        return p
    def attn(prefix=""):
        p.update({f"{prefix}wq": dense(d, h * hd), f"{prefix}wk": dense(d, kv * hd),
                  f"{prefix}wv": dense(d, kv * hd),
                  f"{prefix}wo": dense(h * hd, d, depth_scale)})

    attn()
    if kind == "xdec":
        p["norm_x"] = zeros()
        attn("x_")
    if kind in ("hymba_g", "hymba_l"):
        p["ssm"] = init_ssm_params(gen, n, d, cfg.d_inner, cfg.ssm_state,
                                   cfg.ssm_conv_width, dtype, device)
        p["fuse_a"], p["fuse_s"] = zeros(), zeros()
    p["norm2"] = zeros()
    if kind in ("moe", "moe_swa"):
        p["moe"] = init_moe_params(gen, n, d, f, cfg.moe, dtype, device)
    else:
        p["ffn"] = {"w_gate": dense(d, f), "w_up": dense(d, f),
                    "w_down": dense(f, d, depth_scale)}
    return p


def init_block(gen: torch.Generator, kind: str, cfg: ModelConfig, device):
    """Parameters of one layer (no leading dim)."""
    return layer_params(init_stack(gen, kind, 1, cfg, device), 0)


def layer_params(stack: dict, i: int) -> dict:
    """View of layer ``i`` of a stacked-parameter dict (no copy)."""
    return {k: (layer_params(v, i) if isinstance(v, dict) else v[i])
            for k, v in stack.items()}


def unstack_layers(stack: dict, n: int) -> list[dict]:
    """Views of the ``n`` layers of a stacked-parameter dict, from one
    ``unbind`` per leaf.  Under autograd, :func:`layer_params` would give each
    layer's backward a zero-filled gradient of the whole stack to add up, n
    passes over every stacked leaf; ``unbind``'s backward stacks the n layer
    gradients once."""
    cols = {k: (unstack_layers(v, n) if isinstance(v, dict) else v.unbind(0))
            for k, v in stack.items()}
    return [{k: col[i] for k, col in cols.items()} for i in range(n)]


# ------------------------------------------------------------------- caches
def map_cache(fn, cache):
    """Apply ``fn`` to every tensor of a (nested tuple / NamedTuple) cache."""
    if isinstance(cache, torch.Tensor):
        return fn(cache)
    leaves = (map_cache(fn, c) for c in cache)
    return type(cache)(*leaves) if hasattr(cache, "_fields") else tuple(leaves)


def stack_caches(caches: list):
    """Per-layer caches of one structure -> one cache with a leading layer
    dim on every leaf."""
    first = caches[0]
    if isinstance(first, torch.Tensor):
        return torch.stack(caches)
    leaves = (stack_caches(list(group)) for group in zip(*caches))
    return type(first)(*leaves) if hasattr(first, "_fields") else tuple(leaves)


def _copy_into(dst, src) -> None:
    """Write a layer's new cache into its view of the stacked cache, leaf by
    leaf (a leaf updated in place is skipped)."""
    if isinstance(dst, torch.Tensor):
        if src is not dst:
            dst.copy_(src)
        return
    for d, s in zip(dst, src):
        _copy_into(d, s)


def init_block_cache(kind: str, cfg: ModelConfig, batch: int, cache_len: int,
                     enc_len: int = 0, device=None):
    """Cache for ONE layer of ``kind``: a ring KVCache (of length
    ``min(sliding_window, cache_len)`` for windowed kinds), with the SSM
    state beside it for Hymba, or with the cross K and V over ``enc_len``
    encoder positions for ``xdec``; the mLSTM / sLSTM state; ``()`` for
    ``enc``."""
    _check_kind(kind)
    dtype = dtype_of(cfg.dtype)

    def kvc(length):
        return KVCache.init(batch, length, cfg.n_kv_heads, cfg.hd, dtype, device)

    win = min(cfg.sliding_window, cache_len)
    if kind in ("attn", "moe"):
        return kvc(cache_len)
    if kind in ("swa", "moe_swa"):
        return kvc(win)
    if kind in ("hymba_g", "hymba_l"):
        return (kvc(cache_len if kind == "hymba_g" else win),
                init_ssm_state(batch, cfg.d_inner, cfg.ssm_state,
                               cfg.ssm_conv_width, dtype, device))
    if kind == "xdec":
        def cross():
            return torch.zeros((batch, enc_len, cfg.n_kv_heads, cfg.hd),
                               dtype=dtype, device=device)
        return kvc(cache_len), cross(), cross()
    if kind == "mlstm":
        return init_mlstm_state(batch, cfg.n_heads, cfg.qk, cfg.hd, device)
    if kind == "slstm":
        return init_slstm_state(batch, cfg.n_heads, cfg.hd, device)
    return ()                               # enc


# ---------------------------------------------------------------- attention
def _split_sum(y, w, full: int):
    """``y``, a product through ``w``, summed over the model group when
    ``w`` is row-split (its input dim smaller than ``full``)."""
    return model_sum(y) if w.shape[-2] != full else y


def _out_proj(p, out, cfg: ModelConfig):
    return _split_sum(out.reshape(*out.shape[:2], -1) @ p["wo"], p["wo"],
                      cfg.n_heads * cfg.hd)


def _ffn(h, p, cfg: ModelConfig):
    return _split_sum(swiglu(h, p["w_gate"], p["w_up"], p["w_down"]),
                      p["w_down"], cfg.d_ff)


def _moe(p, h, cfg: ModelConfig):
    sctx = get_shard_context()
    if cfg.moe_impl == "sharded" and sctx is not None:
        return moe_ffn_sharded(p, h, cfg.moe, *sctx)
    # global dispatch: capacity is ranked over the whole batch, so a
    # row-split batch routes all rows and keeps its own
    return _split_sum(local_rows(moe_ffn(p, rows_gather(h), cfg.moe)),
                      p["w_down"], cfg.d_ff)


def _qkv(p, x, cfg: ModelConfig, angles):
    b, s, _ = x.shape
    hd = cfg.hd
    h, kv = p["wq"].shape[-1] // hd, p["wk"].shape[-1] // hd    # local heads
    q = (x @ p["wq"]).reshape(b, s, h, hd)
    k = (x @ p["wk"]).reshape(b, s, kv, hd)
    v = (x @ p["wv"]).reshape(b, s, kv, hd)
    if angles is not None:
        q = apply_rope(q, angles)
        k = apply_rope(k, angles)
    return q, k, v


def _attn_seq(p, x, cfg, angles, window: int, bidir: bool = False):
    q, k, v = _qkv(p, x, cfg, angles)
    s = x.shape[1]
    if cfg.attn_impl == "qchunk" and not bidir:
        out = gqa_attention_qchunk(q, k, v, causal=True, window=window,
                                   chunk=cfg.attn_chunk)
    else:
        mask = (full_mask(s, s, device=x.device) if bidir
                else causal_mask(s, s, window, device=x.device))
        fn = (gqa_attention_bf16 if cfg.attn_impl in ("bf16", "qchunk")
              else gqa_attention)
        out = fn(q, k, v, mask)
    return _out_proj(p, out, cfg), (k, v)


def _attn_decode(p, x, cfg, angles, cache: KVCache, position: int):
    q, k, v = _qkv(p, x, cfg, angles)
    cache = cache.update(k, v, position)
    out = gqa_attention(q, cache.k, cache.v, cache.decode_mask())
    return _out_proj(p, out, cfg), cache


def _attn_decode_paged(p, x, cfg, angles, cache: PagedKV, ctx):
    """One decode token per row against the row's block run in the paged KV
    pool, each row at its OWN absolute position.  The default dense path
    equals :func:`_attn_decode` per row; ``ctx["paged_impl"] == "kernel"``
    runs the CUDA paged attention kernel over the block tables (allclose, not
    bitwise: the engine's deployment switch).

    A row-split step on a mesh keeps the arena replicated over the data
    axes: every process writes every row's new K/V (gathered over the data
    axes, at the whole step's write index ``ctx["paged_write_index"]``),
    then attends over its own rows, so a row that moves to another data
    slice between steps finds its blocks current."""
    qkv = _qkv(p, x, cfg, angles)
    if ctx.get("paged_impl", "dense") == "kernel":
        out, cache = _paged_decode_kernel(qkv, cache, ctx)
    elif rows_split():
        q_new, k_new, v_new = qkv
        paged_write(cache, rows_gather(k_new), rows_gather(v_new),
                    *ctx["paged_write_index"])
        out = paged_attend_dense(q_new, cache, ctx["paged_tables"],
                                 ctx["paged_positions"],
                                 ctx["paged_block_size"])
    else:
        out, cache = paged_decode_attention_dense(
            qkv, cache, ctx["paged_tables"], ctx["paged_positions"],
            ctx["paged_block_size"])
    return pin_rows(_out_proj(p, out, cfg)), cache


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
    Full attention, einsum/bf16 impls only: qchunk's blocked softmax sums in
    another order, so substituting bf16 would break the
    chunked-prefill-equals-monolithic contract."""
    if cfg.attn_impl not in ("einsum", "bf16"):
        raise NotImplementedError(
            f"prefill_cont requires attn_impl 'einsum' or 'bf16', got "
            f"{cfg.attn_impl!r}")
    fn = gqa_attention_bf16 if cfg.attn_impl == "bf16" else gqa_attention
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
    return (_out_proj(p, out, cfg),
            KVCache.from_prefill(k_all, v_all, 0, reserve))


def _cross_attn(p, x, cfg, enc_kv=None, enc_out=None):
    """Cross-attention: q from x (no rope), k / v from the encoder's output,
    or the pair cached after prefill; fp32 attention under a full mask."""
    b, s, _ = x.shape
    h, kv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    q = (x @ p["x_wq"]).reshape(b, s, h, hd)
    if enc_kv is None:
        se = enc_out.shape[1]
        k = (enc_out @ p["x_wk"]).reshape(b, se, kv, hd)
        v = (enc_out @ p["x_wv"]).reshape(b, se, kv, hd)
    else:
        k, v = enc_kv
    out = gqa_attention(q, k, v, full_mask(s, k.shape[1], device=x.device))
    return out.reshape(b, s, -1) @ p["x_wo"], (k, v)


# ------------------------------------------------------------------- apply
def apply_block(kind: str, cfg: ModelConfig, p, x, ctx, cache, mode: str):
    if mode in ("prefill_cont", "decode_paged") and kind != "attn":
        # 'moe' is full-attention but its expert capacity is ranked ACROSS
        # the batch, so suffix-only dispatch would differ from a monolithic
        # prefill; the paged pool likewise only holds full-attention KV (no
        # ring placement, no recurrent state)
        raise NotImplementedError(
            f"{mode} (paged/prefix KV reuse) supports pure full-attention "
            f"'attn' stacks only, got {kind!r}")
    _check_kind(kind)
    if mode not in MODES:
        raise ValueError(f"unknown mode {mode}")
    rs = cfg.residual_scale
    eps = cfg.norm_eps
    angles = ctx.get("angles")
    window = cfg.sliding_window if kind in WINDOWED else 0
    reserve = ctx.get("reserve", 0)
    new_cache = cache

    if kind in ("attn", "swa", "moe", "moe_swa", "enc"):
        h = rms_norm(x, p["norm1"], eps)
        if mode == "decode":
            a, new_cache = _attn_decode(p, h, cfg, angles, cache, ctx["position"])
        elif mode == "decode_paged":
            a, new_cache = _attn_decode_paged(p, h, cfg, angles, cache, ctx)
        elif mode == "prefill_cont":
            a, new_cache = _attn_cont(p, h, cfg, angles, cache, reserve)
        else:
            a, (k, v) = _attn_seq(p, h, cfg, angles, window, bidir=kind == "enc")
            if mode == "prefill":
                new_cache = KVCache.from_prefill(k, v, window, reserve)
        x = x + rs * a
        h = rms_norm(x, p["norm2"], eps)
        if kind in ("moe", "moe_swa"):
            return x + rs * _moe(p["moe"], h, cfg), new_cache
        return x + rs * _ffn(h, p["ffn"], cfg), new_cache

    if kind in ("hymba_g", "hymba_l"):
        h = rms_norm(x, p["norm1"], eps)
        if mode == "decode":
            kvc, sst = cache
            a, kvc = _attn_decode(p, h, cfg, angles, kvc, ctx["position"])
            s_out, sst = ssm_step(p["ssm"], h, sst)
            new_cache = (kvc, sst)
        else:
            a, (k, v) = _attn_seq(p, h, cfg, angles, window)
            if mode == "prefill":
                s_out, sst = ssm_prefill_state(p["ssm"], h, chunk=cfg.scan_chunk)
                new_cache = (KVCache.from_prefill(k, v, window, reserve), sst)
            else:
                s_out, _ = ssm_sequence(p["ssm"], h, chunk=cfg.scan_chunk)
        fused = 0.5 * (rms_norm(a, p["fuse_a"], eps) + rms_norm(s_out, p["fuse_s"], eps))
        x = x + rs * fused
        h = rms_norm(x, p["norm2"], eps)
        return x + rs * _ffn(h, p["ffn"], cfg), new_cache

    if kind == "xdec":
        h = rms_norm(x, p["norm1"], eps)
        if mode == "decode":
            kvc, xk, xv = cache
            a, kvc = _attn_decode(p, h, cfg, angles, kvc, ctx["position"])
            x = x + rs * a
            h = rms_norm(x, p["norm_x"], eps)
            a, _ = _cross_attn(p, h, cfg, enc_kv=(xk, xv))
            new_cache = (kvc, xk, xv)
        else:
            a, (k, v) = _attn_seq(p, h, cfg, angles, 0)
            x = x + rs * a
            h = rms_norm(x, p["norm_x"], eps)
            a, (xk, xv) = _cross_attn(p, h, cfg, enc_out=ctx["enc_out"])
            if mode == "prefill":
                new_cache = (KVCache.from_prefill(k, v, 0, reserve), xk, xv)
        x = x + rs * a
        h = rms_norm(x, p["norm2"], eps)
        return x + rs * _ffn(h, p["ffn"], cfg), new_cache

    h = rms_norm(x, p["norm1"], eps)
    if kind == "mlstm":
        if mode == "decode":
            y, new_cache = mlstm_step(p, h, cfg.n_heads, cfg.qk, cfg.hd, cache)
        else:
            y, st = mlstm_sequence(p, h, cfg.n_heads, cfg.qk, cfg.hd,
                                   chunk=cfg.scan_chunk)
            if mode == "prefill":
                new_cache = st
    else:                                   # slstm
        if mode == "decode":
            y, new_cache = slstm_step(p, h, cfg.n_heads, cfg.hd, cache)
        else:
            y, st = slstm_sequence(p, h, cfg.n_heads, cfg.hd)
            if mode == "prefill":
                new_cache = st
    return x + rs * y, new_cache


# ------------------------------------------------------------------- stacks
def apply_stack(kind: str, cfg: ModelConfig, stack, x, ctx, cache=None,
                mode: str = "train"):
    """Run ``apply_block`` over the layers of a stacked-parameter stack.

    cache: the stack's cache (leading layer dim on every leaf), a stacked
    PagedKV for ``decode_paged``, or None.  Returns (x, cache): for
    ``prefill`` and ``prefill_cont`` a newly stacked cache, for ``decode``
    and ``decode_paged`` the cache passed in, updated in place, for
    ``train`` None.

    Rematerialisation, the reference's ``cfg.remat`` (``blocks.py:396-402``):
    in mode ``train`` with gradients on, ``"full"`` keeps only each layer's
    input and runs the layer again in the backward pass
    (``torch.utils.checkpoint``, non-reentrant).  ``"dots"`` (keep the
    weight products' outputs, JAX's ``checkpoint_dots_with_no_batch_dims``)
    has no PyTorch policy of the same reach and maps to ``"full"``: the
    values and gradients are the same either way, only the memory held
    between the passes differs.  ``"none"`` keeps every activation.
    """
    n = stack["norm1"].shape[0]
    remat = mode == "train" and torch.is_grad_enabled() and cfg.remat in ("full", "dots")
    emitted = []
    for i, p in enumerate(unstack_layers(stack, n)):
        if remat:
            x = checkpoint(lambda h, p=p: apply_block(kind, cfg, p, h, ctx, None, mode)[0],
                           x, use_reentrant=False)
            continue
        c = map_cache(lambda leaf: leaf[i], cache) if cache is not None else None
        x, c2 = apply_block(kind, cfg, p, x, ctx, c, mode)
        x = constrain(x)
        if mode in ("prefill", "prefill_cont"):
            emitted.append(c2)
        elif mode == "decode":
            _copy_into(c, c2)
    if emitted:
        return x, stack_caches(emitted)
    return x, (cache if mode in ("decode", "decode_paged") else None)
