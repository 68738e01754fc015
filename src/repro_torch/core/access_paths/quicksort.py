"""Comparison-based quick sort (Sec. 3.2, Algorithms 2 & 3).

* ``votes = 1``  — vanilla LLM quick sort (Lotus-style).
* ``votes = v>1`` — quick sort with majority voting: each item is compared to
  the pivot *and* to ``v-1`` peers sampled from the opposite initial
  partition.  Unanimous items are placed immediately; conflicted items wait
  until their peers are firmly classified, then Algorithm 2's weighted vote
  decides (initial pivot comparison carries weight 1.5).  A deadlock (no
  waiting item has fully classified peers) is broken by voting with the
  current partial partitions.

LIMIT-K pushdown = partial quick sort (Martinez '04): only the prefix-covering
partitions are recursed into, giving O(v(N + K log K)) calls.

Probe plan: the recursion is flattened into a **wavefront over partitions**.
Every live subproblem (a segment awaiting partitioning, at its pivot or
peer-vote stage, or a 2-element segment awaiting its single comparison)
contributes its ready comparisons to ONE ``ComparePairs`` round per
scheduling step, so sibling partitions — which the old recursive form
serialized — advance together and the plan suspends ~2·depth times instead
of ~2·(#partitions).  Pruning is decided the moment a partition's split is
known: a child whose output offset falls at or past LIMIT K is never
expanded, exactly the calls the sequential recursion would skip.  The
comparison set (and therefore the ledger multiset) is identical to the
recursive form; only the round grouping changes.

Counterpart of ``src/repro/core/access_paths/quicksort.py`` (copied; only imports and
cross-references point at the port)."""
from __future__ import annotations

import hashlib
from typing import Optional, Sequence

import numpy as np

from ..executor import ComparePairs
from ..types import Key, SortSpec
from .base import AccessPath, PathParams, _log2, register


def _det_sample(pool: list[Key], k: int, seed_parts) -> list[Key]:
    if k <= 0 or not pool:
        return []
    # stable digest, NOT builtin hash(): str hashing is randomized per
    # process (PYTHONHASHSEED), which made peer sampling — and therefore
    # quick-sort outputs — vary run to run
    h = hashlib.blake2b(repr(seed_parts).encode(), digest_size=8)
    rng = np.random.default_rng(int.from_bytes(h.digest(), "little"))
    idx = rng.choice(len(pool), size=min(k, len(pool)), replace=False)
    return [pool[i] for i in idx]


def _flatten(piece, out: list) -> None:
    """In-order traversal of the nested slot tree built by the plan."""
    for item in piece:
        if isinstance(item, Key):
            out.append(item)
        else:
            _flatten(item, out)


@register("quick")
class QuickSort(AccessPath):
    """Set ``params.votes`` to 1 for vanilla, 3 for the paper's ``quick_3``."""

    # ---- wavefront probe plan ---------------------------------------------
    def _plan(self, keys: Sequence[Key], spec: SortSpec):
        keys = list(keys)
        if len(keys) <= 1:
            return keys
        out_root: list = []
        active: list[dict] = []

        def spawn(seg: list[Key], limit: Optional[int], slot: list) -> None:
            # a child whose local LIMIT budget is exhausted would only rank
            # positions >= K: never expanded (partial quick sort pruning)
            if limit is not None and limit <= 0:
                return
            if len(seg) <= 1:
                slot.append(list(seg))
                return
            stage = "pair" if len(seg) == 2 else "pivot"
            active.append({"keys": list(seg), "limit": limit, "slot": slot,
                           "stage": stage})

        spawn(keys, spec.limit, out_root)
        while active:
            current, active = active, []
            pairs: list = []
            spans: list[tuple[int, int]] = []
            for node in current:
                prs = self._node_pairs(node)
                spans.append((len(pairs), len(pairs) + len(prs)))
                pairs.extend(prs)
            flags = yield ComparePairs(pairs)
            for node, (i, j) in zip(current, spans):
                self._node_advance(node, flags[i:j], spawn, active)
        out: list[Key] = []
        _flatten(out_root, out)
        return out

    def _node_pairs(self, node: dict) -> list:
        """The comparisons this subproblem needs at its current stage."""
        if node["stage"] == "pair":
            a, b = node["keys"]
            return [(a, b)]
        if node["stage"] == "pivot":
            pivot, rest = node["keys"][0], node["keys"][1:]
            return [(x, pivot) for x in rest]
        return node["flat_peers"]          # stage == "peers"

    def _node_advance(self, node: dict, res: list, spawn, active: list) -> None:
        """Consume one round's results, then finalize or re-arm the node."""
        if node["stage"] == "pair":
            a, b = node["keys"]
            node["slot"].append([a, b] if res[0] else [b, a])
            return
        pivot, rest = node["keys"][0], node["keys"][1:]
        if node["stage"] == "pivot":
            initial = {x.uid: f for x, f in zip(rest, res)}
            if self.params.votes <= 1:
                front = [x for x in rest if initial[x.uid]]
                back = [x for x in rest if not initial[x.uid]]
                self._finalize(node, pivot, front, back, spawn)
                return
            # arm the peer-vote round: peers sampled from the opposite
            # initial partition (Algorithm 3)
            init_front = [x for x in rest if initial[x.uid]]
            init_back = [x for x in rest if not initial[x.uid]]
            peers_of: dict[int, list[Key]] = {}
            for x in rest:
                pool = init_back if initial[x.uid] else init_front
                peers_of[x.uid] = _det_sample(
                    [y for y in pool if y.uid != x.uid],
                    self.params.votes - 1, ("qs-peers", x.uid, pivot.uid))
            node["initial"] = initial
            node["peers_of"] = peers_of
            node["flat_peers"] = [(x, y) for x in rest
                                  for y in peers_of[x.uid]]
            node["stage"] = "peers"
            active.append(node)
            return
        # stage == "peers": Algorithm 2's deferred weighted-vote resolution
        flat_res = iter(res)
        results_of = {x.uid: [next(flat_res) for _ in node["peers_of"][x.uid]]
                      for x in rest}
        front, back = self._resolve_partition(
            rest, node["initial"], node["peers_of"], results_of)
        self._finalize(node, pivot, front, back, spawn)

    def _finalize(self, node: dict, pivot: Key, front: list[Key],
                  back: list[Key], spawn) -> None:
        """Split known: schedule both children (they run concurrently from
        the next round on) and prune everything past the LIMIT budget."""
        slot, limit = node["slot"], node["limit"]
        front_slot: list = []
        slot.append(front_slot)
        spawn(front, limit, front_slot)
        if limit is not None and len(front) >= limit:
            return                          # pivot and back land past K
        slot.append([pivot])
        rem = None if limit is None else limit - len(front) - 1
        back_slot: list = []
        slot.append(back_slot)
        spawn(back, rem, back_slot)

    # ---- Algorithm 2 vote resolution ---------------------------------------
    def _resolve_partition(self, rest: list[Key], initial: dict,
                           peers_of: dict, results_of: dict):
        front: list[Key] = []
        back: list[Key] = []
        placed: dict[int, bool] = {}  # uid -> placed-in-front?
        deferred: list[tuple[Key, bool, list[Key], list[bool]]] = []

        for x in rest:
            r_init = initial[x.uid]
            peers = peers_of[x.uid]
            peer_results = results_of[x.uid]
            allres = [r_init] + peer_results
            if all(allres):
                front.append(x); placed[x.uid] = True
            elif not any(allres):
                back.append(x); placed[x.uid] = False
            else:
                deferred.append((x, r_init, peers, peer_results))

        # iterative resolution; Algorithm 2 vote once peers are classified
        while deferred:
            progressed = False
            still: list[tuple[Key, bool, list[Key], list[bool]]] = []
            for item in deferred:
                x, r_init, peers, peer_results = item
                if all(y.uid in placed for y in peers):
                    self._vote_place(item, placed, front, back)
                    progressed = True
                else:
                    still.append(item)
            deferred = still
            if deferred and not progressed:
                # deadlock: resolve the head with current partial partitions
                self._vote_place(deferred.pop(0), placed, front, back)

        return front, back

    @staticmethod
    def _vote_place(item, placed: dict[int, bool], front: list[Key], back: list[Key]):
        """Algorithm 2: weighted vote.  'front' plays the paper's L role."""
        x, r_init, peers, peer_results = item
        f_vote = 1.5 if r_init else 0.0
        b_vote = 0.0 if r_init else 1.5
        for y, r_y in zip(peers, peer_results):
            side = placed.get(y.uid)          # True=front, False=back, None=unplaced
            if side is True and r_y:          # y in L and x before y => x in L
                f_vote += 1.0
            elif side is False and not r_y:   # y in G and x after y => x in G
                b_vote += 1.0
        if f_vote > b_vote:
            front.append(x); placed[x.uid] = True
        else:
            back.append(x); placed[x.uid] = False

    # ---- Table 1 --------------------------------------------------------------
    @classmethod
    def est_calls(cls, n: int, k: Optional[int], params: PathParams) -> float:
        v = max(params.votes, 1)
        if k is None or k >= n:
            return v * n * _log2(n)
        return v * (n + k * _log2(k))
