"""Public wrappers of the package's kernels.

Counterpart of ``src/repro/kernels/ops.py``.  Ported so far:
``paged_decode_attention``.  The dispatch is by the tensor's device alone: a
CUDA tensor goes to the CUDA kernel or raises, a CPU tensor takes the plain
PyTorch version.  The reference's ``REPRO_FORCE_REF`` /
``REPRO_FORCE_INTERPRET`` knobs have no counterpart here.  ``flash_attention``,
``decode_attention``, ``topk_scores``, ``borda_count``, ``ssm_scan``,
``mlstm_scan`` and ``moe_gating`` come with the slices that bring their
callers.
"""
from __future__ import annotations

from .paged_attention import paged_attention as _paged


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


flash_attention = _not_ported("flash_attention", "the scheduler/core slice")
decode_attention = _not_ported("decode_attention", "the scheduler/core slice")
moe_gating = _not_ported("moe_gating", "the MoE/Hymba/xLSTM blocks slice")
ssm_scan = _not_ported("ssm_scan", "the MoE/Hymba/xLSTM blocks slice")
mlstm_scan = _not_ported("mlstm_scan", "the MoE/Hymba/xLSTM blocks slice")
topk_scores = _not_ported("topk_scores", "the training slice")
borda_count = _not_ported("borda_count", "the training slice")
