"""Sharding rules: parameter partition specs + batch specs for a
``("data", "model")`` mesh (``("pod", "data", "model")`` multi-pod; batch
always shards over all data-like axes).

Counterpart of ``src/repro/distributed/sharding.py``, with the same rules,
tables and divisibility checks.  A spec is a :class:`P`, a tuple of entries
(``None``, an axis name or a tuple of names) in which a 1-tuple is its bare
name, as ``PartitionSpec`` normalises it.  Trees are the port's: dicts walked
by key, lists and tuples by index (``lm.param_tree()``, batch dicts, per-stack
cache lists of ``KVCache`` / ``PagedKV``); a leaf is anything with a
``shape``.  A mesh is a ``DeviceMesh`` or anything with ``axis_names`` and a
``shape`` dict (``launch.mesh.AbstractMesh``).

Where the reference commits arrays to ``NamedSharding``s (``named``), the
port cuts each leaf to this process's slice: :func:`local_shard`.

Plan knobs:
  fsdp     shard weight matrices' non-TP dim over the data axes (gathered
           back per stack at use: memory <-> collective trade)
  zero1    shard optimizer moments over the data axes even when params are
           replicated there
  seq_shard_cache, cache_layout
           where a decode cache's sequence dim is cut (:func:`cache_specs`;
           the port's model holds a KV cache so cut through
           :func:`cache_seq_cut`, when its caller asks for the plan's
           layout)
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch


@dataclass(frozen=True)
class ShardingPlan:
    fsdp: bool = False
    zero1: bool = True
    # decode-time long-context: shard the KV/seq dim of caches over data axes
    seq_shard_cache: bool = True
    # decode cache layout: "feature" shards kv-heads/head_dim over `model`
    # (baseline); "seq" shards the cache sequence dim over `model` instead
    cache_layout: str = "feature"


class P(tuple):
    """A partition spec: one entry per leading dim, ``None`` (replicated),
    an axis name or a tuple of axis names.  ``P(("data",)) == P("data")``."""

    def __new__(cls, *entries):
        return super().__new__(cls, (_norm(e) for e in entries))

    def __repr__(self) -> str:
        return f"P{tuple(self)!r}"


def _norm(entry):
    if isinstance(entry, (tuple, list)):
        entry = tuple(entry)
        return entry[0] if len(entry) == 1 else entry
    return entry


def axis_names(mesh) -> tuple:
    names = getattr(mesh, "mesh_dim_names", None)
    return tuple(names) if names is not None else tuple(mesh.axis_names)


def axis_size(mesh, name: str) -> int:
    """Size of axis ``name`` of a DeviceMesh or an abstract mesh."""
    if isinstance(mesh.shape, dict):
        return int(mesh.shape[name])
    return int(mesh.size(axis_names(mesh).index(name)))


def axes_size(mesh, axes) -> int:
    axs = axes if isinstance(axes, tuple) else (axes,)
    return int(np.prod([axis_size(mesh, a) for a in axs], dtype=np.int64))


def data_axes(mesh) -> tuple:
    return tuple(a for a in axis_names(mesh) if a in ("pod", "data"))


MODEL = "model"

# leaf-name -> (model_dim, fsdp_dim); dims index into leaf.shape AFTER the
# leading stacked-layer dim(s) are skipped.  None = replicated on that front.
_RULES: dict[str, tuple[Optional[int], Optional[int]]] = {
    # attention / generic projections (d_in, d_out)
    "wq": (1, 0), "wk": (1, 0), "wv": (1, 0), "wo": (0, 1),
    "x_wq": (1, 0), "x_wk": (1, 0), "x_wv": (1, 0), "x_wo": (0, 1),
    # FFN
    "w_gate": (1, 0), "w_up": (1, 0), "w_down": (0, 1),
    # MoE (E, d, f) leaves handled by ndim offset below; router (d, E)
    "router": (None, 0),
    # SSM
    "w_in": (1, 0), "conv_w": (1, None), "conv_b": (0, None),
    "w_dt_in": (0, None), "w_dt_out": (1, 0), "dt_bias": (0, None),
    "w_B": (0, None), "w_C": (0, None), "A_log": (0, None),
    "D_skip": (0, None), "w_out": (0, 1),
    # xLSTM
    "w_q": (1, 0), "w_k": (1, 0), "w_v": (1, 0), "w_og": (1, 0),
    "w_i": (None, 0), "w_f": (None, 0), "gn_scale": (0, None),
    "w_z": (1, 0), "r_z": (None, None), "b_z": (0, None),
    "r_i": (None, None), "b_i": (0, None),
    "r_f": (None, None), "b_f": (0, None),
    "w_o": (1, 0), "r_o": (None, None), "b_o": (0, None),
    # norms
    "norm1": (None, None), "norm2": (None, None), "norm_x": (None, None),
    "fuse_a": (None, None), "fuse_s": (None, None),
}

_TOP_LEVEL = {
    "embed": (0, None),       # vocab-parallel embedding (Megatron style)
    "lm_head": (1, 0),        # (D, V): V over model, D over data when fsdp
    "final_norm": (None, None),
    "enc_norm": (None, None),
}


# ------------------------------------------------------------------ trees
def _is_leaf(x) -> bool:
    return hasattr(x, "shape") and not isinstance(x, (dict, list, tuple))


def map_with_path(fn, tree, path: tuple = ()):
    """``fn(path, leaf)`` over a tree of dicts, lists and (named) tuples;
    the path holds dict keys (str) and sequence indices (int).  A :class:`P`
    is a leaf."""
    if isinstance(tree, P) or _is_leaf(tree):
        return fn(path, tree)
    if isinstance(tree, dict):
        return {k: map_with_path(fn, v, path + (k,)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        out = [map_with_path(fn, v, path + (i,)) for i, v in enumerate(tree)]
        if hasattr(tree, "_fields"):
            return type(tree)(*out)
        return type(tree)(out) if isinstance(tree, tuple) else out
    return fn(path, tree)


def map_tree(fn, *trees):
    """``fn(leaf, *others)`` over trees of one structure (the first tree
    decides what a leaf is)."""
    first = trees[0]
    if isinstance(first, P) or _is_leaf(first):
        return fn(*trees)
    if isinstance(first, dict):
        return {k: map_tree(fn, *(t[k] for t in trees)) for k in first}
    if isinstance(first, (list, tuple)):
        out = [map_tree(fn, *parts) for parts in zip(*trees)]
        if hasattr(first, "_fields"):
            return type(first)(*out)
        return type(first)(out) if isinstance(first, tuple) else out
    return fn(*trees)


def _leaf_name(path) -> str:
    for entry in reversed(path):
        if isinstance(entry, str):
            return entry
    return ""


def _n_leading_stack_dims(path) -> int:
    """Stack params carry a leading layer dim; MoE experts add one more."""
    names = [e for e in path if isinstance(e, str)]
    lead = 0
    if "stacks" in names or "enc_stacks" in names:
        lead += 1
    if "moe" in names and names[-1] != "router":
        lead += 1  # (E, d, f)
    return lead


def _fit(dim_size: int, axes, mesh):
    """Return the axis (or axis tuple) only if it divides dim_size."""
    if axes is None:
        return None
    return axes if dim_size % axes_size(mesh, axes) == 0 else None


# ------------------------------------------------------------------ specs
def param_specs(params_shape, mesh, plan: ShardingPlan = ShardingPlan()):
    """Spec tree matching a parameter tree (``lm.param_tree()``)."""
    daxes = data_axes(mesh)

    def spec_for(path, leaf) -> P:
        name = _leaf_name(path)
        shape = tuple(leaf.shape)
        nd = len(shape)
        if name in _TOP_LEVEL:
            m_dim, f_dim = _TOP_LEVEL[name]
            lead = 0
        elif name in _RULES:
            m_dim, f_dim = _RULES[name]
            lead = _n_leading_stack_dims(path)
        else:
            return P()
        entries: list = [None] * nd
        if m_dim is not None and lead + m_dim < nd:
            i = lead + m_dim
            entries[i] = _fit(shape[i], MODEL, mesh)
            if entries[i] is None and name in ("embed", "lm_head"):
                # odd vocab: fall back to model-sharding the d_model dim
                # instead of replicating the whole table
                j = lead + (1 - m_dim) if nd >= lead + 2 else None
                if j is not None and entries[j] is None:
                    entries[j] = _fit(shape[j], MODEL, mesh)
        if plan.fsdp and f_dim is not None and lead + f_dim < nd:
            j = lead + f_dim
            if entries[j] is None:
                entries[j] = _fit(shape[j], daxes, mesh)
        return P(*entries)

    return map_with_path(spec_for, params_shape)


def zero1_specs(params_shape, pspecs, mesh, plan: ShardingPlan):
    """Optimizer-moment specs: params' specs, plus (if zero1 and not fsdp)
    the first free divisible dim sharded over the data axes."""
    daxes = data_axes(mesh)

    def extend(leaf, spec: P):
        if not plan.zero1 or plan.fsdp:
            return spec
        shape = tuple(leaf.shape)
        entries = list(spec) + [None] * (len(shape) - len(spec))
        for i, (dim, e) in enumerate(zip(shape, entries)):
            if e is None and _fit(dim, daxes, mesh) is not None and dim > 1024:
                entries[i] = daxes
                break
        return P(*entries)

    return map_tree(extend, params_shape, pspecs)


def batch_specs(batch_shape, mesh):
    """Shard every batch leaf's batch dim over the data axes.  Leaves whose
    leading dim is 3 (M-RoPE position triplets) shard dim 1 instead."""
    daxes = data_axes(mesh)

    def spec_for(leaf) -> P:
        shape = tuple(leaf.shape)
        if len(shape) >= 2 and shape[0] == 3:           # (3, B, S) positions
            return P(None, _fit(shape[1], daxes, mesh))
        if len(shape) == 0:
            return P()
        return P(_fit(shape[0], daxes, mesh))

    return map_tree(spec_for, batch_shape)


def cache_specs(cache_shape, mesh, plan: ShardingPlan = ShardingPlan()):
    """Decode caches: layer-stacked leaves (n, B, S, KV, hd) etc.
    Shard batch over data axes when divisible; otherwise shard the seq/state
    dim over data axes (context parallelism); shard the KV-head / feature
    dim over model when divisible."""
    daxes = data_axes(mesh)

    def spec_for(leaf) -> P:
        shape = tuple(leaf.shape)
        nd = len(shape)
        if nd <= 1:
            return P()
        entries: list = [None] * nd
        # leading dim is the stacked-layer dim; dim1 = batch
        b_ax = _fit(shape[1], daxes, mesh)
        entries[1] = b_ax
        if b_ax is None and plan.seq_shard_cache and nd >= 3:
            entries[2] = _fit(shape[2], daxes, mesh)
        if plan.cache_layout == "seq" and nd >= 3 and entries[2] is None:
            # context parallelism: cache seq over `model`
            entries[2] = _fit(shape[2], MODEL, mesh)
        if not any(_norm(e) == MODEL for e in entries):
            # feature layout: model axis on the last divisible big dim
            for i in range(nd - 1, 1, -1):
                if entries[i] is None and _fit(shape[i], MODEL, mesh) \
                        and shape[i] >= 16:
                    entries[i] = MODEL
                    break
        return P(*entries)

    return map_tree(spec_for, cache_shape)


@dataclass(frozen=True)
class SeqCut:
    """A KV cache's sequence dim cut over ``axes`` into ``parts`` equal,
    contiguous slices, of which this process holds slice ``index`` (its
    flat coordinate over ``axes``, the first axis outermost, as
    :func:`local_shard` cuts).  Not a tuple, so that the cache trees that
    carry it (``models.layers.KVCacheSlice``) keep it as one leaf."""
    axes: tuple
    parts: int
    index: int


def cache_seq_cut(plan: ShardingPlan, mesh, batch: int, slots: int) -> Optional[SeqCut]:
    """Where :func:`cache_specs` cuts dim 2 of a decode cache leaf
    ``(n, batch, slots, ...)`` of a ``batch``-row (global) batch, and this
    process's slice of it: over the data axes when ``batch`` does not divide
    them and ``plan.seq_shard_cache`` is set, otherwise over ``model`` under
    ``plan.cache_layout == "seq"``, in both cases only where ``slots``
    divides the axes; None where nothing is cut (no such axes, or one
    part)."""
    daxes = data_axes(mesh)
    axes = None
    if _fit(batch, daxes, mesh) is None and plan.seq_shard_cache:
        axes = _fit(slots, daxes, mesh)
    if axes is None and plan.cache_layout == "seq":
        axes = _fit(slots, MODEL, mesh)
    if axes is None:
        return None
    axs = axes if isinstance(axes, tuple) else (axes,)
    parts = axes_size(mesh, axs)
    return SeqCut(axs, parts, axes_coord(mesh, axs)) if parts > 1 else None


def arena_specs(arenas, mesh, plan: ShardingPlan = ShardingPlan()):
    """Serve-time paged-arena layout (``ServeEngine(mesh=...)``): PagedKV
    leaves are (n_layers, num_blocks, block_size, KV, hd).  Feature layout
    only: kv-heads over ``model`` when divisible (head_dim as the fallback
    for odd kv counts), and every OTHER dim, the block dim above all,
    replicated, so the pool's free list, refcounts and stashes stay
    host-side and mesh-oblivious: a block id means the same arena slice on
    every device."""

    def spec_for(leaf) -> P:
        shape = tuple(leaf.shape)
        nd = len(shape)
        if nd != 5:
            return P()
        entries: list = [None] * nd
        entries[3] = _fit(shape[3], MODEL, mesh)
        if entries[3] is None:
            entries[4] = _fit(shape[4], MODEL, mesh)
        return P(*entries)

    return map_tree(spec_for, arenas)


def rows_spec(n_rows: int, ndim: int, mesh, axis: int = 0) -> P:
    """Probe/decode submission batches on a serving mesh: shard the row dim
    (``axis``; 0 for token batches, 1 for stacked caches) over the data axes:
    THE data-parallel row split.  Each data shard executes a contiguous row
    slice of the padded submission; rows that do not divide stay
    replicated."""
    entries: list = [None] * ndim
    entries[axis] = _fit(n_rows, data_axes(mesh), mesh) if n_rows > 0 else None
    return P(*entries)


# ------------------------------------------------------ this process's part
def axes_coord(mesh, axes) -> int:
    """This process's flat coordinate over ``axes`` (the first axis is the
    outermost), the index of its contiguous slice of a dim split over
    them."""
    axs = axes if isinstance(axes, tuple) else (axes,)
    coord = 0
    for a in axs:
        coord = coord * axis_size(mesh, a) + int(mesh.get_local_rank(a))
    return coord


def local_shape(shape, spec: P, mesh) -> tuple:
    """The shape of this process's slice of a leaf of ``shape`` under
    ``spec``."""
    out = list(shape)
    for i, e in enumerate(spec):
        if e is not None:
            out[i] //= axes_size(mesh, e)
    return tuple(out)


def local_shard(tree, specs, mesh):
    """Each leaf cut to this process's contiguous slice: along every dim
    with a spec entry, part ``axes_coord`` of ``axes_size`` equal parts.  A
    leaf replicated everywhere is returned as it is; a cut leaf is a copy
    (a view of a dim-0 cut would keep the whole leaf's storage alive)."""

    def cut(leaf, spec: P):
        out = leaf
        for i, e in enumerate(spec):
            if e is None:
                continue
            n = axes_size(mesh, e)
            if n == 1:
                continue
            size = leaf.shape[i] // n
            out = out.narrow(i, axes_coord(mesh, e) * size, size)
        return out if out is leaf else out.clone(memory_format=torch.contiguous_format)

    return map_tree(cut, tree, specs)
