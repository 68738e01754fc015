"""The comparison that decides ``correct``.

Exact numbers (limit 0):

* ``failed_queries``: queries returned since the window opened whose plan
  raised, and, where the mix waits for them, queries submitted in the
  window that did not return;
* ``readout_faults``: probe rows answered in the window whose raw answer
  (compare verdict, score, membership) differs from the read-out of the
  row's served logits worked out here (``reference.readout``);
* ``order_faults``: queries returned since the window opened whose order
  the reference does not derive from
  the answers the oracle gave: for ``pointwise``, the LIMIT first keys of
  the stable sort by score; for ``quick`` with one vote, every compared
  pair of keys that both stand in the output in the order its verdict put
  them, and one billed call per compared pair.

Against the fp32 reference, over a sample drawn from the seed of the probe
rows answered in the window, the longest always in it:

* ``probe_logit_gap``: the largest distance of a row's six read-out logits
  from the reference's, over the spread of the reference's logits at that
  row.

The reference is the configuration's architecture's (``Reference`` of
``bench/architectures/<name>.py``).  ``control=True`` also reads the gap
for that reference run in fp8 (``quant="fp8"``) put in the program's
place.
"""
from __future__ import annotations

import numpy as np

from . import reference as ref

ROW_KINDS = ("compare", "score_each", "inquire", "score_batches", "rank_windows")


def _flat(r) -> list:
    if r.kind in ("score_batches", "rank_windows"):
        return [it for b in r.payload for it in b]
    return list(r.payload)


def _raw_rows(r) -> list:
    if r.kind == "score_batches":
        return [v for b in r.raw for v in b]
    return list(r.raw)


def readout_faults(queries) -> int:
    """Over the rounds answered in the window."""
    bad = 0
    for q in queries:
        for r in q.rounds:
            if r.kind == "rank_windows" or not r.in_window:
                continue
            for six, raw in zip(r.six, _raw_rows(r)):
                if ref.readout(r.kind, six) != raw:
                    bad += 1
    return bad


def order_fault(q, mix: dict) -> bool:
    """Does the query's order differ from what its answers give?"""
    order = [k.uid for k in q.result.order]
    desc = q.spec.descending
    if mix["path"] == "pointwise":
        (r,) = [r for r in q.rounds if r.kind == "score_each"]
        uids = [u for u, _t in r.payload]
        folded = [-s if desc else s for s in r.raw]
        want = [uids[i] for i in sorted(range(len(uids)), key=folded.__getitem__)]
        return (want[:q.spec.limit] != order
                or q.n_calls != len(uids))
    if mix["path"] == "quick" and mix.get("params", {}).get("votes", 1) == 1:
        pos = {u: i for i, u in enumerate(order)}
        pairs = 0
        for r in q.rounds:
            for ((a, _ta), (b, _tb)), raw in zip(r.payload, r.raw):
                pairs += 1
                first = raw > 0 if desc else raw < 0
                if a in pos and b in pos and (pos[a] < pos[b]) != first:
                    return True
        return q.n_calls != pairs
    return False


def _sample(rng, pool: list, size_of, n: int) -> list:
    if not pool:
        return []
    longest = max(range(len(pool)), key=lambda i: size_of(pool[i]))
    rest = [i for i in range(len(pool)) if i != longest]
    pick = rng.choice(len(rest), size=min(n - 1, len(rest)), replace=False)
    return [pool[longest]] + [pool[rest[i]] for i in sorted(pick)]


def window_rows(queries) -> list:
    """``(prompt, six)`` of every probe row answered in the window: the
    row's prompt worked out again, its six read-out logits as served."""
    return [(ref.round_prompts(r.kind if r.kind in ("compare", "inquire")
                               else "score_each", [it], r.criteria)[0], six)
            for q in queries for r in q.rounds
            if r.kind in ROW_KINDS and r.in_window
            for it, six in zip(_flat(r), r.six)]


def model_gaps(queries, arch, model: dict, weights: dict, seed: int,
               n_probe: int, control: bool = False) -> dict:
    rng = np.random.default_rng([int(seed), 7])
    probes = _sample(rng, window_rows(queries),
                     lambda row: len(ref.prompt_ids(row[0])), n_probe)
    fp32 = arch.Reference(model, weights, quant="none")
    low = arch.Reference(model, weights, quant="fp8") if control else None
    out: dict = {"probe_rows": len(probes)}
    gaps, ctrl_gaps = [], []
    for prompt, six in probes:
        ids = ref.padded_row(ref.prompt_ids(prompt))
        want = fp32.logits(ids, [len(ids) - 1])[0]
        gaps.append(ref.row_gap(want, six))
        if low is not None:
            got = low.logits(ids, [len(ids) - 1])[0]
            ctrl_gaps.append(ref.row_gap(want, got[list(ref.READOUT_COLUMNS)]
                                         .double().cpu().numpy()))
    if probes:
        out["probe_logit_gap"] = max(gaps)
        if low is not None:
            out["control_probe_logit_gap"] = max(ctrl_gaps)
    return out
