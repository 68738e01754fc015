"""The dense decoder: the port's ``attn`` block, one stack of it.

A configuration whose file names no ``architecture`` serves this model.
RMSNorm with scale ``1 + w``, full rotary embedding in the half-split
layout, causal softmax attention with ``n_kv_heads`` shared by groups of
query heads, SwiGLU, a final RMSNorm and an untied head (``DESIGN.md``).

Exports what ``bench/harness/cell.py`` asks of an architecture file:
``draw``, ``program_config``, ``program_tree``, ``Reference`` and
``prompt_flops``.  Imports torch and ``bench.harness.reference`` only:
nothing of the program.

The weights.  One ``torch.Generator`` on the device, seeded with the
configuration's ``weights_seed`` (never the run's ``--seed``, which draws
the traffic: a deployment serves one model whatever queries come), draws
each stacked leaf of every layer in one call, directly in the served dtype
(bf16), in a fixed order: the same seed gives the same weights.  Matrix
weights have std ``1 / sqrt(d_in)`` (the output products of a layer also
``1 / sqrt(2 n_layers)``), norm scales are ``0.1 N(0, 1)`` in fp32 around
the ``1 + w`` of the norm, so a reference that got the norm wrong would
show.  The same tensors go to the program and to the reference.

The FLOP count is worked from the configuration's published widths: it
counts what the work needs, so padding, cache reuse or a fused kernel
change the time and never the count.
"""
from __future__ import annotations

import math

import torch

from bench.harness.reference import fp32_exact, product


# ------------------------------------------------------------------ weights
def draw(model: dict, seed: int, device) -> dict:
    """The reference's weight dict (see ``Reference``)."""
    d, h, kv = model["d_model"], model["n_heads"], model["n_kv_heads"]
    hd = model.get("head_dim") or d // h
    f, v, n = model["d_ff"], model["vocab_size"], model["n_layers"]
    gen = torch.Generator(device=device).manual_seed(int(seed))
    depth = 1.0 / math.sqrt(2.0 * n)

    def normal(shape, std):
        w = torch.randn(shape, generator=gen, device=device,
                        dtype=torch.bfloat16)
        return w.mul_(std)

    def scale(shape):
        return torch.randn(shape, generator=gen, device=device,
                           dtype=torch.float32).mul_(0.1)

    layers = {
        "norm1": scale((n, d)),
        "wq": normal((n, d, h * hd), 1 / math.sqrt(d)),
        "wk": normal((n, d, kv * hd), 1 / math.sqrt(d)),
        "wv": normal((n, d, kv * hd), 1 / math.sqrt(d)),
        "wo": normal((n, h * hd, d), depth / math.sqrt(h * hd)),
        "norm2": scale((n, d)),
        "w_gate": normal((n, d, f), 1 / math.sqrt(d)),
        "w_up": normal((n, d, f), 1 / math.sqrt(d)),
        "w_down": normal((n, f, d), depth / math.sqrt(f)),
    }
    return {"embed": normal((v, d), 1 / math.sqrt(d)),
            "final_norm": scale((d,)),
            "lm_head": normal((d, v), 1 / math.sqrt(d)),
            "layers": layers}


# ------------------------------------------------------------------ program
def program_config(model_config, config: dict):
    """The port's ``ModelConfig`` of the configuration file ``config``
    (``model_config``: the port's ``models.config`` module)."""
    model = config["model"]
    return model_config.ModelConfig(
        name=config["name"], family="dense", n_layers=model["n_layers"],
        d_model=model["d_model"], n_heads=model["n_heads"],
        n_kv_heads=model["n_kv_heads"], d_ff=model["d_ff"],
        vocab_size=model["vocab_size"], head_dim=model.get("head_dim", 0),
        pattern=(("attn", model["n_layers"]),), rope_theta=model["rope_theta"],
        norm_eps=model["norm_eps"], dtype="bfloat16")


def program_tree(weights: dict) -> dict:
    """The same tensors in the program's parameter tree (one stack of
    ``attn`` layers, the SwiGLU leaves nested under ``ffn``)."""
    L = weights["layers"]
    stack = {k: L[k] for k in ("norm1", "wq", "wk", "wv", "wo", "norm2")}
    stack["ffn"] = {k: L[k] for k in ("w_gate", "w_up", "w_down")}
    return {"embed": weights["embed"], "final_norm": weights["final_norm"],
            "lm_head": weights["lm_head"], "stacks": [stack]}


# ---------------------------------------------------------------- reference
class Reference:
    """The model of one configuration over given weights.

    ``weights``: ``embed`` (V, d), ``final_norm`` (d,), ``lm_head`` (d, V)
    and ``layers``, a dict of stacked leaves with a leading layer dim:
    ``norm1``, ``wq``, ``wk``, ``wv``, ``wo``, ``norm2``, ``w_gate``,
    ``w_up``, ``w_down``, each weight laid out (d_in, d_out).  ``head`` is
    the (d, V) tensor the logits read.  ``quant``: see
    ``reference.product``."""

    def __init__(self, model: dict, weights: dict, quant: str = "none"):
        self.m = model
        self.w = weights
        self.head = weights["lm_head"]
        self.quant = quant
        self._fp8_weights: dict = {}
        d, h = model["d_model"], model["n_heads"]
        self.hd = model.get("head_dim") or d // h

    def _mm(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        return product(x, w, self.quant, self._fp8_weights)

    def _norm(self, x, scale):
        var = x.square().mean(dim=-1, keepdim=True)
        return x * torch.rsqrt(var + self.m["norm_eps"]) * (1.0 + scale.float())

    def _rope(self, x, pos):
        half = self.hd // 2
        inv = 1.0 / (self.m["rope_theta"] ** (
            torch.arange(half, dtype=torch.float32, device=x.device) / half))
        ang = pos.float()[:, None] * inv                    # (S, half)
        cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
        x1, x2 = x[..., :half], x[..., half:]
        return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)

    def _layer(self, i: int, x: torch.Tensor) -> torch.Tensor:
        m, L = self.m, self.w["layers"]
        s = x.shape[0]
        h, kv, hd = m["n_heads"], m["n_kv_heads"], self.hd
        pos = torch.arange(s, device=x.device)
        a = self._norm(x, L["norm1"][i])
        q = self._rope(self._mm(a, L["wq"][i]).view(s, h, hd), pos)
        k = self._rope(self._mm(a, L["wk"][i]).view(s, kv, hd), pos)
        v = self._mm(a, L["wv"][i]).view(s, kv, hd)
        g = h // kv
        k = k.repeat_interleave(g, dim=1)
        v = v.repeat_interleave(g, dim=1)
        scores = torch.einsum("qhd,khd->hqk", q, k) / math.sqrt(hd)
        causal = torch.ones(s, s, dtype=torch.bool, device=x.device).tril()
        scores = scores.masked_fill(~causal, float("-inf"))
        att = torch.einsum("hqk,khd->qhd", torch.softmax(scores, dim=-1), v)
        x = x + self._mm(att.reshape(s, h * hd), L["wo"][i])
        f = self._norm(x, L["norm2"][i])
        gate = torch.nn.functional.silu(self._mm(f, L["w_gate"][i]))
        up = self._mm(f, L["w_up"][i])
        return x + self._mm(gate * up, L["w_down"][i])

    @torch.no_grad()
    def hidden(self, ids: list, at: list) -> torch.Tensor:
        """fp32 final-normed hidden states (len(at), d) of the row ``ids``
        (already padded) at positions ``at``."""
        w = self.w
        dev = w["embed"].device
        with fp32_exact():
            x = w["embed"][torch.tensor(ids, device=dev)].float()
            for i in range(self.m["n_layers"]):
                x = self._layer(i, x)
            return self._norm(x[torch.tensor(at, device=dev)], w["final_norm"])

    @torch.no_grad()
    def logits(self, ids: list, at: list) -> torch.Tensor:
        """fp32 logits (len(at), V) of the row ``ids`` at positions ``at``."""
        with fp32_exact():
            return self._mm(self.hidden(ids, at), self.w["lm_head"])


# -------------------------------------------------------------------- FLOPs
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
