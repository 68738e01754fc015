"""The plain reference: the served model's forward pass in fp32, and the
probe prompts and read-outs, worked out again from the benchmark's inputs.

Imports only torch and numpy: nothing of the program.  It takes the weight
tensors the benchmark drew (the same ones it loaded into the program) and
the tables the benchmark generated, and derives everything else itself:
the byte tokens, the probe prompts, the left padding to the row's padded
length, the positions and the logits.

What it follows, and why.  The served system defines a probe's answer as
the last-position logits of the prompt's tokens left-padded with the PAD id
to the next power of two (at least 16); the model has no padding mask, so
the PAD tokens are part of the row.  The layer is the port's dense block (``DESIGN.md``): RMSNorm with
scale ``1 + w``, full rotary embedding in the half-split layout, causal
softmax attention with ``n_kv_heads`` shared by groups of query heads,
SwiGLU, a final RMSNorm and an untied head.

Everything runs in fp32 with TF32 off, one row and one layer at a time,
each weight cast from its served bf16 as the layer needs it.  ``quant="fp8"``
is the control: every matrix product's weight and input rounded to
float8 e4m3 (one scale a weight column, one a token) before the product.
``quant="bf16"`` (products in the served bf16) serves only the weights'
construction (``weights.balance_readouts``), never the check.
"""
from __future__ import annotations

import contextlib
import math

import numpy as np
import torch

PAD, BOS, EOS = 256, 257, 258
TOK_A, TOK_B = ord("A"), ord("B")
TOK_HI, TOK_LO = ord("9"), ord("0")
TOK_YES, TOK_NO = ord("Y"), ord("N")
READOUT_COLUMNS = (TOK_A, TOK_B, TOK_HI, TOK_LO, TOK_YES, TOK_NO)


# ----------------------------------------------------------- prompts, tokens
def encode(text: str, bos: bool = True) -> list:
    ids = list(text.encode("utf-8"))
    return [BOS] + ids if bos else ids


def prompt_ids(prompt) -> list:
    """Token ids of a prompt: a string, or a (prefix, suffix) pair served
    as one text."""
    if isinstance(prompt, str):
        return encode(prompt)
    prefix, suffix = prompt
    return encode(prefix + suffix)


def padded_length(n: int) -> int:
    return 1 << max(max(n, 16) - 1, 0).bit_length()


def padded_row(ids: list) -> list:
    return [PAD] * (padded_length(len(ids)) - len(ids)) + list(ids)


def compare_prompt(a: str, b: str, criteria: str) -> tuple:
    return (f"Criteria: {criteria}\nPassage B: {b}\n",
            f"Passage A: {a}\nWhich ranks higher? Answer:")


def score_prompt(text: str, criteria: str) -> tuple:
    return (f"Criteria: {criteria}\nItem:", f" {text}\nRating:")


def inquire_prompt(text: str, criteria: str) -> tuple:
    return (f"You have seen the following {criteria}: \"",
            f"{text}\" in your training data? Answer Y or N:")


def round_prompts(kind: str, payload, criteria: str) -> list:
    """The prompts of one probe round, one per row, from its kind and its
    payload of ``(uid, text)`` items (pairs for ``compare``)."""
    if kind == "compare":
        return [compare_prompt(a[1], b[1], criteria) for a, b in payload]
    if kind == "inquire":
        return [inquire_prompt(t, criteria) for _u, t in payload]
    return [score_prompt(t, criteria) for _u, t in payload]


def readout(kind: str, six) -> object:
    """A round row's raw answer from its six read-out logits (in the order
    of ``READOUT_COLUMNS``): a compare verdict +1 / -1, a score, a
    membership boolean (a score is ``score_each``'s and ``score_batches``'
    row's)."""
    a, b, hi, lo, yes, no = np.asarray(six, np.float32)
    if kind == "compare":
        return 1 if a > b else -1
    if kind == "inquire":
        return bool(yes > no)
    return float(hi - lo)             # a float32 difference, as served


# ---------------------------------------------------------------- the model
@contextlib.contextmanager
def fp32_exact():
    """TF32 off for the reference's products, restored on exit."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32,
             torch.get_float32_matmul_precision())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved[0]
        torch.backends.cudnn.allow_tf32 = saved[1]
        torch.set_float32_matmul_precision(saved[2])


def _fp8(x: torch.Tensor, dim: int) -> torch.Tensor:
    """x rounded to float8 e4m3 with one scale along ``dim``'s slices
    (amax over ``dim`` mapped to the format's largest value 448)."""
    amax = x.abs().amax(dim=dim, keepdim=True).clamp_min(1e-12)
    scale = 448.0 / amax
    return (x * scale).to(torch.float8_e4m3fn).float() / scale


class Reference:
    """The model of one configuration over given weights.

    ``weights``: ``embed`` (V, d), ``final_norm`` (d,), ``lm_head`` (d, V)
    and ``layers``, a dict of stacked leaves with a leading layer dim:
    ``norm1``, ``wq``, ``wk``, ``wv``, ``wo``, ``norm2``, ``w_gate``,
    ``w_up``, ``w_down``, each weight laid out (d_in, d_out)."""

    def __init__(self, model: dict, weights: dict, quant: str = "none"):
        self.m = model
        self.w = weights
        self.quant = quant
        self._fp8_weights: dict = {}
        d, h = model["d_model"], model["n_heads"]
        self.hd = model.get("head_dim") or d // h

    def _mm(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        if self.quant == "bf16":
            return (x.to(w.dtype) @ w).float()
        if self.quant == "fp8":
            key = (w.data_ptr(), tuple(w.shape))
            if key not in self._fp8_weights:      # rounded once, kept
                self._fp8_weights[key] = _fp8(w.float(), 0)
            return _fp8(x, -1) @ self._fp8_weights[key]
        return x @ w.float()

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


def row_gap(ref_row: torch.Tensor, served: np.ndarray) -> float:
    """The largest distance of the served read-out logits from the
    reference's, over the reference's spread of that row's logits."""
    ref = ref_row.double().cpu()
    cols = torch.tensor(READOUT_COLUMNS)
    diff = (ref[cols] - torch.from_numpy(np.asarray(served, np.float64))).abs()
    return float(diff.max() / ref.std())

