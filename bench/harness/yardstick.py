"""The yardstick: the card's peak and the FLOPs the answered work needs.

The peak is a copy of ``src/repro_torch/launch/mesh.py`` (commit
59c63ea40a24): NVIDIA's H100 SXM data sheet, the dense bf16 rate at 700 W.
The FLOP count is this benchmark's own, worked from a configuration's
published widths: it counts what the work needs, so padding, cache reuse or
a fused kernel change the time and never the count.
"""
from __future__ import annotations

PEAK_FLOPS_BF16 = 989e12    # FLOP/s, dense bf16 on the tensor cores


def _dims(model: dict) -> tuple:
    d, h, kv = model["d_model"], model["n_heads"], model["n_kv_heads"]
    hd = model.get("head_dim") or d // h
    return d, h, kv, hd, model["d_ff"], model["vocab_size"], model["n_layers"]


def matmul_flops_per_token(model: dict) -> int:
    """2 x the weights one token multiplies in one pass of every layer:
    q, k, v, o and the three SwiGLU products."""
    d, h, kv, hd, f, _v, n = _dims(model)
    per_layer = d * h * hd + 2 * d * kv * hd + h * hd * d + 3 * d * f
    return 2 * n * per_layer


def head_flops(model: dict) -> int:
    """The output head at one position."""
    d, _h, _kv, _hd, _f, v, _n = _dims(model)
    return 2 * d * v


def prompt_flops(model: dict, length: int) -> int:
    """One forward over ``length`` unpadded tokens, causal, with the head at
    the last position only (a single-token probe's read-out): the weight
    products of every token, q.k and p.v over each token's own prefix
    (``length (length + 1) / 2`` pairs, 4 FLOPs a pair and a head dim),
    and the head once."""
    _d, h, _kv, hd, _f, _v, n = _dims(model)
    pairs = length * (length + 1) // 2
    return (length * matmul_flops_per_token(model) + n * 4 * h * hd * pairs
            + head_flops(model))

