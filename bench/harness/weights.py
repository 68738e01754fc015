"""The served weights' last step of set-up: the read-out pairs of the head
centred on the traffic's prompts.

The weights themselves are drawn by the configuration's architecture
(``bench/architectures/<name>.py``: ``draw``), on the device from the
configuration's ``weights_seed``; the same tensors go to the program and to
the reference.
"""
from __future__ import annotations

import torch


def balance_readouts(arch, weights: dict, model: dict, prompts: dict) -> None:
    """Centre each read-out pair of the head on the traffic's prompts.

    ``prompts`` maps a pair of token ids (the two tokens a probe's answer
    compares: ``A``/``B``, ``9``/``0``, ``Y``/``N``) to a few prompts of
    that probe kind.  Random weights give prompts of one kind nearly the
    same final hidden state, so without this a pair's logit difference has
    an offset larger than its spread over the keys, and every verdict of a
    seed comes out the same (a quicksort then compares n^2 / 2 pairs).  The
    difference of the pair's two head columns loses its component along
    the mean final hidden state of those prompts (the reference's of the
    architecture ``arch``, with its products in bf16), split between the two
    columns; what depends on the keys stays.
    """
    from .reference import padded_row, prompt_ids
    ref = arch.Reference(model, weights, quant="bf16")
    head = ref.head
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
