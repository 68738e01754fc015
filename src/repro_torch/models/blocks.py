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
layer gets this process's slice of its parameters, cut as the reference's
``param_specs`` cuts them, and is tensor-parallel in the Megatron style:
``wq`` / ``wk`` / ``wv`` / ``w_gate`` / ``w_up`` and the experts' F dim
column-split, ``wo`` / ``w_down`` row-split and their products summed over
the ``model`` group.  A cut of the flattened ``n_heads * hd`` may fall
inside a head: a process attends the whole heads its rows of ``wo`` read
(``layers.head_span``), taking q / k / v from its own columns where they
are exactly those heads and from the products gathered over ``model``
otherwise, and keeps its own columns of the output; its caches hold the kv
heads it attends.  The SSM and xLSTM blocks do the same over their own
cuts (``ssm.py``, ``xlstm.py``).  Spans are read off the weights; a product
is summed exactly when its contracted dim is smaller than the config's, so
without a mesh nothing changes.  ``moe_impl="sharded"``
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
                                   model_column_range, model_rank,
                                   model_row_sum, pin_rows, rows_gather,
                                   rows_split)
from .config import ModelConfig
from .layers import (HeadSpan, KVCache, PagedKV, apply_rope, causal_mask,
                     cut_rows, dtype_of, full_mask, gqa_attention,
                     gqa_attention_bf16, gqa_attention_qchunk, head_span,
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


def kv_heads_on(cfg: ModelConfig, model: int, rank: int) -> int:
    """The kv heads the process at ``rank`` of a model axis of ``model``
    attends, and so caches (:func:`~.layers.head_span`)."""
    if model == 1:
        return cfg.n_kv_heads
    h, hd = cfg.n_heads, cfg.hd
    return head_span(h, cfg.n_kv_heads, hd, cut_rows(h * hd, model), rank).nkv


def init_block_cache(kind: str, cfg: ModelConfig, batch: int, cache_len: int,
                     enc_len: int = 0, device=None, model: int = 1, rank: int = 0):
    """Cache for ONE layer of ``kind``: a ring KVCache (of length
    ``min(sliding_window, cache_len)`` for windowed kinds), with the SSM
    state beside it for Hymba, or with the cross K and V over ``enc_len``
    encoder positions for ``xdec``; the mLSTM / sLSTM state; ``()`` for
    ``enc``.  On a model axis of ``model`` the process at ``rank`` holds
    what its layer computes: the kv heads and recurrent heads of its
    :func:`~.layers.head_span`, its slice of the SSM's channels."""
    _check_kind(kind)
    dtype = dtype_of(cfg.dtype)
    h, hd = cfg.n_heads, cfg.hd

    def kvc(length):
        return KVCache.init(batch, length, kv_heads_on(cfg, model, rank), hd,
                            dtype, device)

    win = min(cfg.sliding_window, cache_len)
    if kind in ("attn", "moe"):
        return kvc(cache_len)
    if kind in ("swa", "moe_swa"):
        return kvc(win)
    if kind in ("hymba_g", "hymba_l"):
        return (kvc(cache_len if kind == "hymba_g" else win),
                init_ssm_state(batch, cut_rows(cfg.d_inner, model), cfg.ssm_state,
                               cfg.ssm_conv_width, dtype, device))
    if kind == "xdec":
        def cross():
            return torch.zeros((batch, enc_len, kv_heads_on(cfg, model, rank), hd),
                               dtype=dtype, device=device)
        return kvc(cache_len), cross(), cross()
    n_rec = head_span(h, h, hd, cut_rows(h * hd, model), rank).nq
    if kind == "mlstm":
        return init_mlstm_state(batch, n_rec, cfg.qk, hd, device)
    if kind == "slstm":
        return init_slstm_state(batch, n_rec, hd, device)
    return ()                               # enc


# ---------------------------------------------------------------- attention
def _split_sum(y, w, full: int):
    """``y``, a product through ``w``, summed over the model group when
    ``w`` is row-split (its input dim smaller than ``full``)."""
    return model_row_sum(y, w.shape[-2], full)


def _span(p, cfg: ModelConfig, prefix: str = "") -> HeadSpan:
    """The heads this process computes: those its output projection's rows
    read (:func:`~.layers.head_span`)."""
    return head_span(cfg.n_heads, cfg.n_kv_heads, cfg.hd,
                     p[f"{prefix}wo"].shape[-2], model_rank())


def _heads(y, full: int, first: int, count: int, hd: int):
    """Heads ``[first, first + count)`` (B, S, count, hd) of ``y``, this
    process's slice of a product through a head projection of ``full``
    columns (:func:`~..distributed.context.model_column_range`)."""
    return model_column_range(y, full, first * hd, count * hd).reshape(
        *y.shape[:2], count, hd)


def _attend(fn, q, k, v, span: HeadSpan, group: int):
    """``fn(q, k, v)`` over the span's heads.  GQA pairs q head ``j`` with kv
    head ``j // group``: where the span's q heads are not whole groups, one
    call a kv head over the q heads of its group that the span holds."""
    if span.grouped(group):
        return fn(q, k, v)
    outs = []
    for j in range(span.nkv):
        lo = max(span.h0, (span.kv0 + j) * group) - span.h0
        hi = min(span.h0 + span.nq, (span.kv0 + j + 1) * group) - span.h0
        outs.append(fn(q[:, :, lo:hi], k[:, :, j:j + 1], v[:, :, j:j + 1]))
    return torch.cat(outs, dim=2)


def _out_proj(p, out, cfg: ModelConfig, span: HeadSpan, prefix: str = ""):
    """The span's attention output (B, S, nq, hd) through this process's
    rows of ``wo``: its columns ``[col0, col0 + cols)``, summed over
    ``model`` where the rows are a cut."""
    y = out.reshape(*out.shape[:2], -1)
    if span.cols != y.shape[-1]:
        y = y.narrow(-1, span.col0, span.cols)
    w = p[f"{prefix}wo"]
    return _split_sum(y @ w, w, cfg.n_heads * cfg.hd)


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


def _qkv(p, x, cfg: ModelConfig, angles, span: HeadSpan):
    hd = cfg.hd
    q = _heads(x @ p["wq"], cfg.n_heads * hd, span.h0, span.nq, hd)
    k = _heads(x @ p["wk"], cfg.n_kv_heads * hd, span.kv0, span.nkv, hd)
    v = _heads(x @ p["wv"], cfg.n_kv_heads * hd, span.kv0, span.nkv, hd)
    if angles is not None:
        q = apply_rope(q, angles)
        k = apply_rope(k, angles)
    return q, k, v


def _group(cfg: ModelConfig) -> int:
    return cfg.n_heads // cfg.n_kv_heads


def _attn_seq(p, x, cfg, angles, window: int, bidir: bool = False):
    span = _span(p, cfg)
    q, k, v = _qkv(p, x, cfg, angles, span)
    s = x.shape[1]
    if cfg.attn_impl == "qchunk" and not bidir:
        def fn(q, k, v):
            return gqa_attention_qchunk(q, k, v, causal=True, window=window,
                                        chunk=cfg.attn_chunk)
    else:
        mask = (full_mask(s, s, device=x.device) if bidir
                else causal_mask(s, s, window, device=x.device))
        att = (gqa_attention_bf16 if cfg.attn_impl in ("bf16", "qchunk")
               else gqa_attention)

        def fn(q, k, v):
            return att(q, k, v, mask)
    out = _attend(fn, q, k, v, span, _group(cfg))
    return _out_proj(p, out, cfg, span), (k, v)


def _attn_decode(p, x, cfg, angles, cache: KVCache, position: int):
    span = _span(p, cfg)
    q, k, v = _qkv(p, x, cfg, angles, span)
    cache = cache.update(k, v, position)
    mask = cache.decode_mask()
    out = _attend(lambda q, k, v: gqa_attention(q, k, v, mask),
                  q, cache.k, cache.v, span, _group(cfg))
    return _out_proj(p, out, cfg, span), cache


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
    span = _span(p, cfg)
    qkv = _qkv(p, x, cfg, angles, span)

    def attend(q, k, v, mask):
        return _attend(lambda q, k, v: gqa_attention(q, k, v, mask),
                       q, k, v, span, _group(cfg))

    if ctx.get("paged_impl", "dense") == "kernel":
        out, cache = _paged_decode_kernel(qkv, cache, ctx)
    elif rows_split():
        q_new, k_new, v_new = qkv
        paged_write(cache, rows_gather(k_new), rows_gather(v_new),
                    *ctx["paged_write_index"])
        out = paged_attend_dense(q_new, cache, ctx["paged_tables"],
                                 ctx["paged_positions"],
                                 ctx["paged_block_size"], attend)
    else:
        out, cache = paged_decode_attention_dense(
            qkv, cache, ctx["paged_tables"], ctx["paged_positions"],
            ctx["paged_block_size"], attend)
    return pin_rows(_out_proj(p, out, cfg, span)), cache


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
    att = gqa_attention_bf16 if cfg.attn_impl == "bf16" else gqa_attention
    span = _span(p, cfg)
    q, k, v = _qkv(p, x, cfg, angles, span)
    b, s = x.shape[:2]
    start = cache.k.shape[1]
    kc, vc = cache.k, cache.v
    if kc.shape[0] != b:
        kc = kc.expand(b, *kc.shape[1:])
        vc = vc.expand(b, *vc.shape[1:])
    k_all = torch.cat([kc, k], dim=1)
    v_all = torch.cat([vc, v], dim=1)
    mask = causal_mask(s, start + s, 0, q_offset=start, device=x.device)
    out = _attend(lambda q, k, v: att(q, k, v, mask), q, k_all, v_all, span,
                  _group(cfg))
    return (_out_proj(p, out, cfg, span),
            KVCache.from_prefill(k_all, v_all, 0, reserve))


def _cross_attn(p, x, cfg, enc_kv=None, enc_out=None):
    """Cross-attention: q from x (no rope), k / v from the encoder's output,
    or the pair cached after prefill (the span's kv heads); fp32 attention
    under a full mask."""
    s = x.shape[1]
    kvw, hd = cfg.n_kv_heads * cfg.hd, cfg.hd
    span = _span(p, cfg, "x_")
    q = _heads(x @ p["x_wq"], cfg.n_heads * hd, span.h0, span.nq, hd)
    if enc_kv is None:
        k = _heads(enc_out @ p["x_wk"], kvw, span.kv0, span.nkv, hd)
        v = _heads(enc_out @ p["x_wv"], kvw, span.kv0, span.nkv, hd)
    else:
        k, v = enc_kv
    mask = full_mask(s, k.shape[1], device=x.device)
    out = _attend(lambda q, k, v: gqa_attention(q, k, v, mask), q, k, v, span,
                  _group(cfg))
    return _out_proj(p, out, cfg, span, "x_"), (k, v)


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
            s_out, sst = ssm_step(p["ssm"], h, sst, d_inner=cfg.d_inner)
            new_cache = (kvc, sst)
        else:
            a, (k, v) = _attn_seq(p, h, cfg, angles, window)
            if mode == "prefill":
                s_out, sst = ssm_prefill_state(p["ssm"], h, chunk=cfg.scan_chunk,
                                               d_inner=cfg.d_inner)
                new_cache = (KVCache.from_prefill(k, v, window, reserve), sst)
            else:
                s_out, _ = ssm_sequence(p["ssm"], h, chunk=cfg.scan_chunk,
                                        d_inner=cfg.d_inner)
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
