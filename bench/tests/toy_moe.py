"""A second architecture for the harness's tests: a tiny Mixtral-style
stack of the port's ``moe`` block.

Full causal attention as ``dense``'s, then a top-k mixture of SwiGLU
experts: the router's logits, the softmax over the ``top_k`` chosen, each
chosen expert's output weighted by its gate.  Its own plain fp32 reference
over the same tensors, on the shared products of ``bench.harness.reference``.
The tests copy this file into a temporary ``architectures/`` beside a
configuration that names it, so the harness finds it as it finds any
architecture: by name, with no harness file touched.

Served in fp32, not bf16: a token whose k-th and (k+1)-th router logits lie
within bf16's rounding goes to another expert in a bf16 program than in
the fp32 reference, and where that token is a read-out position the gap
reads as a fault (a margin of 6e-5 there read 0.36 against the limit
0.13).  A served MoE configuration settles that in its own reference; this
file tests the harness.
"""
from __future__ import annotations

import math

import torch

from bench.harness.reference import fp32_exact, product


def draw(model: dict, seed: int, device) -> dict:
    d, h, kv, hd = model["d_model"], model["n_heads"], model["n_kv_heads"], model["head_dim"]
    f, v, n, e = model["d_ff"], model["vocab_size"], model["n_layers"], model["n_experts"]
    gen = torch.Generator(device=device).manual_seed(int(seed))
    depth = 1.0 / math.sqrt(2.0 * n)

    def normal(shape, std):
        return torch.randn(shape, generator=gen, device=device,
                           dtype=torch.float32).mul_(std)

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
        "router": normal((n, d, e), 1 / math.sqrt(d)),
        "w_gate": normal((n, e, d, f), 1 / math.sqrt(d)),
        "w_up": normal((n, e, d, f), 1 / math.sqrt(d)),
        "w_down": normal((n, e, f, d), depth / math.sqrt(f)),
    }
    return {"embed": normal((v, d), 1 / math.sqrt(d)), "final_norm": scale((d,)),
            "lm_head": normal((d, v), 1 / math.sqrt(d)), "layers": layers}


def program_config(model_config, config: dict):
    """``capacity_factor`` comes from the configuration: the program ranks
    expert slots across the whole submission, and a row whose slot drops
    depends on its batch-mates, which a reference of one row cannot
    follow; a factor of ``n_experts / top_k`` gives every expert a slot for
    every token."""
    m = config["model"]
    return model_config.ModelConfig(
        name=config["name"], family="moe", n_layers=m["n_layers"],
        d_model=m["d_model"], n_heads=m["n_heads"], n_kv_heads=m["n_kv_heads"],
        d_ff=m["d_ff"], vocab_size=m["vocab_size"], head_dim=m["head_dim"],
        pattern=(("moe", m["n_layers"]),), rope_theta=m["rope_theta"],
        norm_eps=m["norm_eps"], dtype="float32",
        moe=model_config.MoESpec(n_experts=m["n_experts"], top_k=m["top_k"],
                                 capacity_factor=m["capacity_factor"]))


def program_tree(weights: dict) -> dict:
    L = weights["layers"]
    stack = {k: L[k] for k in ("norm1", "wq", "wk", "wv", "wo", "norm2")}
    stack["moe"] = {k: L[k] for k in ("router", "w_gate", "w_up", "w_down")}
    return {"embed": weights["embed"], "final_norm": weights["final_norm"],
            "lm_head": weights["lm_head"], "stacks": [stack]}


class Reference:
    def __init__(self, model: dict, weights: dict, quant: str = "none"):
        self.m, self.w, self.head, self.quant = model, weights, weights["lm_head"], quant
        self._rounded: dict = {}

    def _mm(self, x, w):
        return product(x, w, self.quant, self._rounded)

    def _norm(self, x, scale):
        var = x.square().mean(dim=-1, keepdim=True)
        return x * torch.rsqrt(var + self.m["norm_eps"]) * (1.0 + scale.float())

    def _rope(self, x, pos):
        half = self.m["head_dim"] // 2
        inv = 1.0 / (self.m["rope_theta"] ** (
            torch.arange(half, dtype=torch.float32, device=x.device) / half))
        ang = pos.float()[:, None] * inv
        cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
        x1, x2 = x[..., :half], x[..., half:]
        return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)

    def _experts(self, i, f):
        L = self.w["layers"]
        top_k = self.m["top_k"]
        vals, idx = torch.topk(self._mm(f, L["router"][i]), top_k, dim=-1)
        gates = torch.zeros(f.shape[0], self.m["n_experts"], device=f.device)
        gates.scatter_(1, idx, torch.softmax(vals, dim=-1))
        out = torch.zeros_like(f)
        for e in range(self.m["n_experts"]):
            up = self._mm(f, L["w_up"][i][e])
            y = self._mm(torch.nn.functional.silu(self._mm(f, L["w_gate"][i][e])) * up,
                         L["w_down"][i][e])
            out = out + gates[:, e:e + 1] * y
        return out

    def _layer(self, i, x):
        m, L = self.m, self.w["layers"]
        s, h, kv, hd = x.shape[0], m["n_heads"], m["n_kv_heads"], m["head_dim"]
        pos = torch.arange(s, device=x.device)
        a = self._norm(x, L["norm1"][i])
        q = self._rope(self._mm(a, L["wq"][i]).view(s, h, hd), pos)
        k = self._rope(self._mm(a, L["wk"][i]).view(s, kv, hd), pos)
        v = self._mm(a, L["wv"][i]).view(s, kv, hd)
        k, v = k.repeat_interleave(h // kv, dim=1), v.repeat_interleave(h // kv, dim=1)
        scores = torch.einsum("qhd,khd->hqk", q, k) / math.sqrt(hd)
        causal = torch.ones(s, s, dtype=torch.bool, device=x.device).tril()
        att = torch.einsum("hqk,khd->qhd", torch.softmax(
            scores.masked_fill(~causal, float("-inf")), dim=-1), v)
        x = x + self._mm(att.reshape(s, h * hd), L["wo"][i])
        return x + self._experts(i, self._norm(x, L["norm2"][i]))

    @torch.no_grad()
    def hidden(self, ids, at):
        w = self.w
        dev = w["embed"].device
        with fp32_exact():
            x = w["embed"][torch.tensor(ids, device=dev)].float()
            for i in range(self.m["n_layers"]):
                x = self._layer(i, x)
            return self._norm(x[torch.tensor(at, device=dev)], w["final_norm"])

    @torch.no_grad()
    def logits(self, ids, at):
        with fp32_exact():
            return self._mm(self.hidden(ids, at), self.head)


def prompt_flops(model: dict, length: int) -> int:
    """Active weights only: attention, the router, and ``top_k`` experts a
    token."""
    d, h, kv, hd = model["d_model"], model["n_heads"], model["n_kv_heads"], model["head_dim"]
    n, f, e, k = model["n_layers"], model["d_ff"], model["n_experts"], model["top_k"]
    per_layer = 2 * d * h * hd + 2 * d * kv * hd + d * e + k * 3 * d * f
    pairs = length * (length + 1) // 2
    return 2 * n * per_layer * length + n * 4 * h * hd * pairs + 2 * d * model["vocab_size"]
