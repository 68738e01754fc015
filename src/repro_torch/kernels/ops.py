"""Public wrappers of the package's kernels.

Counterpart of ``src/repro/kernels/ops.py``.  Ported so far:
``paged_decode_attention``, ``flash_attention`` and ``decode_attention``.
The dispatch is by the tensor's device alone: a CUDA tensor goes to the CUDA
kernel or raises, a CPU tensor takes the plain PyTorch version.  The
reference's ``REPRO_FORCE_REF`` / ``REPRO_FORCE_INTERPRET`` knobs have no
counterpart here.  As in the reference, the model stack calls only
``paged_decode_attention`` (through ``ServeEngine(paged_kernel=...)``);
``flash_attention`` and ``decode_attention`` are reached through these entry
points.  ``topk_scores``, ``borda_count``, ``ssm_scan``, ``mlstm_scan`` and
``moe_gating`` come with later slices.
"""
from __future__ import annotations

from .decode_attention import decode_attention as _decode
from .flash_attention import flash_attention as _flash
from .paged_attention import paged_attention as _paged


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


def _not_ported(name: str, slice_name: str):
    def fn(*args, **kwargs):
        raise NotImplementedError(
            f"repro_torch.kernels.ops.{name} is not ported yet: it comes "
            f"with {slice_name}")
    fn.__name__ = name
    return fn


moe_gating = _not_ported("moe_gating", "the MoE/Hymba/xLSTM blocks slice")
ssm_scan = _not_ported("ssm_scan", "the MoE/Hymba/xLSTM blocks slice")
mlstm_scan = _not_ported("mlstm_scan", "the MoE/Hymba/xLSTM blocks slice")
topk_scores = _not_ported("topk_scores", "the training slice")
borda_count = _not_ported("borda_count", "the training slice")
