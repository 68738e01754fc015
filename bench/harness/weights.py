"""Random served weights drawn on the device from a configuration's seed.

One ``torch.Generator`` on the device, seeded with the configuration's
``weights_seed`` (never the run's ``--seed``, which draws the traffic: a
deployment serves one model whatever queries come), draws each stacked
leaf of every layer in one call, directly in the served dtype (bf16), in a
fixed order: the same seed gives the same weights.  Matrix
weights have std ``1 / sqrt(d_in)`` (the output products of a layer also
``1 / sqrt(2 n_layers)``), norm scales are ``0.1 N(0, 1)`` in fp32 around
the ``1 + w`` of the norm, so a reference that got the norm wrong would
show.  The same tensors go to the program and to the reference.
"""
from __future__ import annotations

import math

import torch


def draw(model: dict, seed: int, device) -> dict:
    """The reference's weight dict (see ``reference.Reference``)."""
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


def program_tree(weights: dict) -> dict:
    """The same tensors in the program's parameter tree (one stack of
    ``attn`` layers, the SwiGLU leaves nested under ``ffn``)."""
    L = weights["layers"]
    stack = {k: L[k] for k in ("norm1", "wq", "wk", "wv", "wo", "norm2")}
    stack["ffn"] = {k: L[k] for k in ("w_gate", "w_up", "w_down")}
    return {"embed": weights["embed"], "final_norm": weights["final_norm"],
            "lm_head": weights["lm_head"], "stacks": [stack]}


def balance_readouts(weights: dict, model: dict, prompts: dict) -> None:
    """Centre each read-out pair of the head on the traffic's prompts.

    ``prompts`` maps a pair of token ids (the two tokens a probe's answer
    compares: ``A``/``B``, ``9``/``0``, ``Y``/``N``) to a few prompts of
    that probe kind.  Random weights give prompts of one kind nearly the
    same final hidden state, so without this a pair's logit difference has
    an offset larger than its spread over the keys, and every verdict of a
    seed comes out the same (a quicksort then compares n^2 / 2 pairs).  The
    difference of the pair's two head columns loses its component along
    the mean final hidden state of those prompts (the reference's, with
    its products in bf16), split between the two columns; what depends on
    the keys stays.
    """
    from .reference import Reference, padded_row, prompt_ids
    ref = Reference(model, weights, quant="bf16")
    head = weights["lm_head"]
    for (a, b), group in prompts.items():
        rows = [padded_row(prompt_ids(p)) for p in group]
        h = torch.cat([ref.hidden(r, [len(r) - 1]) for r in rows])
        mean = h.mean(dim=0)
        unit = mean / mean.norm()
        ca, cb = head[:, a].float(), head[:, b].float()
        half = 0.5 * torch.dot(ca - cb, unit)
        head[:, a] = (ca - half * unit).to(head.dtype)
        head[:, b] = (cb + half * unit).to(head.dtype)


def balance_prompts(table, seed: int, kinds, n: int = 32) -> dict:
    """``n`` prompts of each probe kind in ``kinds`` (``compare``,
    ``score``, ``inquire``: the read-outs the mix's path reads) over random
    keys of ``table`` (a table no client queries), for
    :func:`balance_readouts`."""
    import numpy as np

    from . import reference as ref
    rows, crit = table.rows, table.criteria
    idx = np.random.default_rng([int(seed), 11]).integers(0, len(rows), (n, 2))
    make = {
        "compare": ((ref.TOK_A, ref.TOK_B), lambda i, j: ref.compare_prompt(
            rows[i][1], rows[j][1], crit)),
        "score": ((ref.TOK_HI, ref.TOK_LO), lambda i, _j: ref.score_prompt(
            rows[i][1], crit)),
        "inquire": ((ref.TOK_YES, ref.TOK_NO), lambda i, _j: ref.inquire_prompt(
            rows[i][1], crit)),
    }
    return {make[k][0]: [make[k][1](i, j) for i, j in idx] for k in kinds}
