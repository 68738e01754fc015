"""Public wrappers of the package's kernels.

Counterpart of ``src/repro/kernels/ops.py``, every entry point ported:
``paged_decode_attention``, ``flash_attention``, ``decode_attention``,
``moe_gating``, ``ssm_scan``, ``mlstm_scan``, ``topk_scores`` and
``borda_count``.
The dispatch is by the tensor's device alone: a CUDA tensor goes to the CUDA
kernel or raises, a CPU tensor takes the plain PyTorch version.  The
reference's ``REPRO_FORCE_REF`` / ``REPRO_FORCE_INTERPRET`` knobs have no
counterpart here.  As in the reference, the model stack calls only
``paged_decode_attention`` (through ``ServeEngine(paged_kernel=...)``); the
others are reached through these entry points, while the model's MoE, SSM
and mLSTM blocks compute the same functions in plain PyTorch, as the
reference's do in XLA.  ``topk_scores`` (LIMIT-K over pointwise scores)
and ``borda_count`` (the optimizer's consensus points) are reached through
these entry points alone, as in the reference, whose ``core/`` ranks in
numpy.
"""
from __future__ import annotations

from .borda_count import borda_count as _borda
from .decode_attention import decode_attention as _decode
from .flash_attention import flash_attention as _flash
from .mlstm_scan import mlstm_scan as _mlstm
from .moe_gating import moe_gating as _moe_gate
from .paged_attention import paged_attention as _paged
from .ssm_scan import ssm_scan as _ssm
from .topk_scores import topk_scores as _topk


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0,
                    q_offset: int = 0, block_q: int = 128, block_k: int = 128):
    """``q_offset`` > 0 runs suffix-only (chunked) prefill over prepended
    KV: the kernel-level counterpart of the serving prefix-KV cache."""
    return _flash(q, k, v, causal=causal, window=window, q_offset=q_offset,
                  block_q=block_q, block_k=block_k)


def decode_attention(q, k_cache, v_cache, pos, *, block_k: int = 256):
    """One query token against a dense ring cache; slot valid where
    ``pos >= 0``."""
    return _decode(q, k_cache, v_cache, pos, block_k=block_k)


def paged_decode_attention(q, k_pool, v_pool, tables, ctx_len):
    """Decode attention over the block-paged KV pool: q (B, H, hd) against
    each row's block run ``tables[b]`` in ``k_pool``/``v_pool``
    (NB, block_size, KV, hd), valid up to ``ctx_len[b]`` (>= 1) tokens."""
    return _paged(q, k_pool, v_pool, tables, ctx_len)


def ssm_scan(x, dt, b_t, c_t, a, *, block_d: int = 256, chunk: int = 64):
    """Mamba selective scan with an fp32 state: x, dt (B, S, D); b_t, c_t
    (B, S, N); a (D, N) -> y (B, S, D) in x's dtype."""
    return _ssm(x, dt, b_t, c_t, a, block_d=block_d, chunk=chunk)


def mlstm_scan(q, k, v, i_g, f_g, *, chunk: int = 64):
    """Stabilised mLSTM: q, k (B, H, S, dqk), v (B, H, S, dv), gates
    (B, H, S) -> h (B, H, S, dv) in q's dtype; q is scaled inside."""
    return _mlstm(q, k, v, i_g, f_g, chunk=chunk)


def moe_gating(logits, k: int, *, block_t: int = 256):
    """Router logits (T, E) -> top-k expert ids (T, k) int32, softmax-of-top-k
    gates (T, k) fp32, row-major arrival ranks per expert (T, k) int32."""
    return _moe_gate(logits, k, block_t=block_t)


def topk_scores(scores, k: int, *, block_n: int = 1024):
    """Two-stage top-k of scores (N,): per-tile candidates, then the top k of
    those.  Returns (values (k,) fp32, indices (k,) int32), largest first."""
    return _topk(scores, k, block_n=block_n)


def borda_count(ballots, n_items: int, *, block_items: int = 128,
                block_ballots: int = 8):
    """Ballots (R, S) int32 (-1 pads) -> Borda points (n_items,) fp32."""
    return _borda(ballots, n_items, block_items=block_items,
                  block_ballots=block_ballots)
