"""Nested trees of tensors walked as the reference walks its pytrees.

No counterpart in ``src/repro/`` (``jax.tree_util`` does this there).  A tree
is nested dicts, lists and tuples with tensors or numpy arrays at the leaves
(:meth:`~repro_torch.models.model.LM.param_tree` gives the parameters so).
The walk order is ``jax.tree_util``'s: the keys of a dict sorted, a list in
order.  So leaf ``i`` of a port tree is leaf ``i`` of the reference's tree
of the same structure, which the optimizer's zips and the checkpoint
layout rely on.  A partition spec (``distributed.sharding.P``, a tuple) is a
leaf, so that a tree of specs flattens beside the tree it describes.
"""
from __future__ import annotations

from typing import Any, Callable

import torch

from ..distributed.sharding import P


def _items(tree):
    if isinstance(tree, P):                 # a partition spec is a leaf
        return None
    if isinstance(tree, dict):
        return [(k, tree[k]) for k in sorted(tree)]
    if isinstance(tree, (list, tuple)):
        return list(enumerate(tree))
    return None


def flatten_with_path(tree, prefix: tuple = ()) -> list[tuple[tuple, Any]]:
    """``[(path, leaf)]`` in the reference's order; a path is the keys and
    indices from the root."""
    items = _items(tree)
    if items is None:
        return [(prefix, tree)]
    return [pl for k, sub in items for pl in flatten_with_path(sub, prefix + (k,))]


def path_str(path: tuple) -> str:
    """``("params", "stacks", 0, "ffn", "w_up")`` ->
    ``"params/stacks/0/ffn/w_up"``, as the reference's checkpoints name
    leaves."""
    return "/".join(str(p) for p in path)


def leaves(tree) -> list:
    return [leaf for _, leaf in flatten_with_path(tree)]


def unflatten(like, flat: list):
    """A tree of ``like``'s structure holding ``flat`` in walk order."""
    it = iter(flat)

    def build(node):
        items = _items(node)
        if items is None:
            return next(it)
        if isinstance(node, dict):
            return {k: build(node[k]) for k in sorted(node)}
        return type(node)(build(sub) for sub in node)

    out = build(like)
    if next(it, None) is not None:
        raise ValueError("more leaves than the tree has")
    return out


def map_tree(fn: Callable, tree, *rest):
    """``fn`` over the leaves of ``tree`` and of ``rest`` (same structure)."""
    flats = [leaves(tree)] + [leaves(r) for r in rest]
    return unflatten(tree, [fn(*xs) for xs in zip(*flats)])


@torch.no_grad()
def copy_tree_(dst, src) -> None:
    """Copy every leaf of ``src`` into the tensor at the same place of
    ``dst``, in place (dtype and device are ``dst``'s)."""
    d, s = leaves(dst), leaves(src)
    if len(d) != len(s):
        raise ValueError(f"{len(s)} leaves do not fit a tree of {len(d)}")
    for a, b in zip(d, s):
        a.copy_(torch.as_tensor(b))
