"""What the plain reference shares across architectures: the probe
prompts and tokens, the padding, the read-outs, and the matrix product in
the precision a check asks for.

Imports only torch and numpy: nothing of the program.  A configuration's
model itself is its architecture's file (``bench/architectures/<name>.py``:
its ``Reference``), which builds on this one; both take the weight tensors
the benchmark drew (the same ones it loaded into the program) and the
tables the benchmark generated, and derive everything else themselves: the
byte tokens, the probe prompts, the left padding to the row's padded
length, the positions and the logits.

What it follows, and why.  The served system defines a probe's answer as
the last-position logits of the prompt's tokens left-padded with the PAD id
to the next power of two (at least 16); the model has no padding mask, so
the PAD tokens are part of the row.

A reference runs in fp32 with TF32 off (``fp32_exact``), one row and one
layer at a time, each weight cast from its served bf16 as the layer needs
it.  ``product`` is every matrix product of every architecture, so each
one's control rounds alike: ``quant="fp8"`` is the control, every product's
weight and input rounded to float8 e4m3 (one scale a weight column, one a
token) before the product; ``quant="bf16"`` (products in the served bf16)
serves only the weights' construction (``weights.balance_readouts``),
never the check.
"""
from __future__ import annotations

import contextlib

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


# ----------------------------------------------------------------- products
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


def product(x: torch.Tensor, w: torch.Tensor, quant: str,
            rounded: dict) -> torch.Tensor:
    """``x @ w`` in fp32 from the served weight ``w`` (d_in, d_out) under
    ``quant``: ``none`` the weight cast to fp32, ``bf16`` the input cast
    to the served dtype, ``fp8`` both rounded to float8 e4m3 (the weight
    once, kept in ``rounded`` by its storage and shape)."""
    if quant == "bf16":
        return (x.to(w.dtype) @ w).float()
    if quant == "fp8":
        key = (w.data_ptr(), tuple(w.shape))
        if key not in rounded:                    # rounded once, kept
            rounded[key] = _fp8(w.float(), 0)
        return _fp8(x, -1) @ rounded[key]
    return x @ w.float()


def row_gap(ref_row: torch.Tensor, served: np.ndarray) -> float:
    """The largest distance of the served read-out logits from the
    reference's, over the reference's spread of that row's logits."""
    ref = ref_row.double().cpu()
    cols = torch.tensor(READOUT_COLUMNS)
    diff = (ref[cols] - torch.from_numpy(np.asarray(served, np.float64))).abs()
    return float(diff.max() / ref.std())

