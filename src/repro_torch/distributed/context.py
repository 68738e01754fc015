"""Activation-sharding and shard contexts, and the collectives the model
needs on a mesh.

Counterpart of ``src/repro/distributed/context.py``: the same two context
variables (an activation spec imposed by a launcher, and the serving
engine's ``(mesh, data axes, model axis)`` shard context) and the same entry
points.  In the reference :func:`constrain` and :func:`pin_rows` are layout
statements to GSPMD and change no value; an eager tensor has no layout, so
here they check the spec against the tensor's shape (and the mesh's axis
names) and return ``x`` itself.

GSPMD inserts the reference's collectives; the port's model calls them
itself, through the helpers below, which read the shard context and are the
identity outside one:

 * :func:`model_sum`: a differentiable sum over the ``model`` group (the
   row-parallel projections ``wo`` / ``w_down`` / ``w_out`` and the
   vocab-parallel embedding); :func:`model_row_sum` sums a product only
   when its weight's rows are a cut;
 * :func:`model_gather`: a differentiable all-gather over ``model`` (the
   vocab-split logits); :func:`model_columns` makes a column-cut product
   whole and :func:`model_column_range` takes a range of its columns (the
   heads a process computes when a cut falls inside a head, an SSM's
   ``x`` / ``z`` halves);
 * :func:`rows_gather`: an all-gather over the data axes of a row-split
   batch, when the context says its rows are split (its data axes are not
   empty).

:func:`gather_over` / :func:`sum_over` / :func:`max_over` take a mesh and
axes explicitly.

Counting mode: on a :class:`CountingMesh` (an abstract mesh seen from the
rank at coordinate 0 of every axis) no process group exists; each collective
records ``(kind, axis, result bytes)`` in the mesh's ``records`` and returns a
result of the right shape without calling ``torch.distributed``.  A backward
pass's collectives are counted the same way.  The dry-run
(``launch/dryrun.py``) counts one rank's program so, on ``meta`` tensors,
for a mesh of any size in one process.
"""
from __future__ import annotations

import contextlib
from contextvars import ContextVar
from typing import Optional

import torch
import torch.distributed as dist

from .sharding import P, axes_coord, axes_size, axis_names, map_tree

_ACT_SPEC: ContextVar[Optional[P]] = ContextVar("act_spec", default=None)
# (mesh, dp_axes tuple, model axis name): the serving engine's shard context
_SHARD_CTX: ContextVar[Optional[tuple]] = ContextVar("shard_ctx", default=None)


@contextlib.contextmanager
def activation_spec(spec: Optional[P]):
    token = _ACT_SPEC.set(spec)
    try:
        yield
    finally:
        _ACT_SPEC.reset(token)


@contextlib.contextmanager
def shard_context(mesh, dp_axes: tuple, model_axis: str = "model"):
    token = _SHARD_CTX.set((mesh, tuple(dp_axes), model_axis))
    try:
        yield
    finally:
        _SHARD_CTX.reset(token)


def get_shard_context() -> Optional[tuple]:
    return _SHARD_CTX.get()


def _check(x, spec: P, mesh) -> None:
    if len(spec) > x.dim():
        raise ValueError(f"spec {spec} has {len(spec)} entries for a tensor "
                         f"of shape {tuple(x.shape)}")
    if mesh is None:
        return
    names = axis_names(mesh)
    for e in spec:
        for a in (e if isinstance(e, tuple) else (e,)):
            if a is not None and a not in names:
                raise ValueError(f"spec {spec} names axis {a!r}; the mesh "
                                 f"has {names}")


def constrain(x):
    """The residual stream (B, S, D) under the launcher's activation spec:
    the spec is checked against ``x`` and the shard context's mesh, and
    ``x`` is returned (an eager tensor carries no layout)."""
    spec = _ACT_SPEC.get()
    if spec is None or x.dim() != 3:
        return x
    ctx = _SHARD_CTX.get()
    _check(x, spec, ctx[0] if ctx is not None else None)
    return x


def pin_rows(x, axis: int = 0):
    """Under a :func:`shard_context` with data axes, the reference pins
    ``x``'s row dim to them.  Here the rows of a split submission already
    are this process's slice (the engine cut them), so the spec is checked
    and ``x`` returned; identity outside any context."""
    ctx = _SHARD_CTX.get()
    if ctx is None or not ctx[1]:
        return x
    entries: list = [None] * x.dim()
    entries[axis] = ctx[1]
    _check(x, P(*entries), ctx[0])
    return x


def sequence_parallel_spec(batch_axes=("data",), seq_axis: str = "model") -> P:
    """Residual stream (B, S, D): batch over data axes, seq over model."""
    return P(batch_axes, seq_axis, None)


# ------------------------------------------------------------ collectives
class CountedGroup:
    """An axis of a :class:`CountingMesh`: its name, its size and the list
    its collectives are recorded in."""

    def __init__(self, axis: str, size: int, records: list):
        self.axis, self.size, self.records = axis, size, records

    def record(self, kind: str, result) -> None:
        self.records.append((kind, self.axis, result.numel() * result.element_size()))


class CountingMesh:
    """The mesh of the rank at coordinate 0 of every axis of ``abstract`` (a
    ``launch.mesh.AbstractMesh``), for counting its collectives: every
    collective over it is recorded in :attr:`records`, none is run."""

    def __init__(self, abstract):
        self.axis_names = tuple(abstract.axis_names)
        self.shape = dict(abstract.shape)
        self.records: list = []

    def get_group(self, axis: str) -> CountedGroup:
        return CountedGroup(axis, self.shape[axis], self.records)

    def get_local_rank(self, axis: str) -> int:
        return 0


class _AllReduce(torch.autograd.Function):
    """Sum over a group; the backward sums the gradients the same way, each
    process's loss being one term of a summed objective
    (``torch.distributed.nn.functional.all_reduce``'s definition, which
    recent PyTorch deprecates).  The model processes of a tensor-parallel
    step share one loss, so that objective is M times it; the sharded
    ``Trainer`` divides its gradients back."""

    @staticmethod
    def forward(ctx, group, x):
        ctx.group = group
        out = x.clone()
        if isinstance(group, CountedGroup):
            group.record("all-reduce", out)
        else:
            dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        return None, _AllReduce.apply(ctx.group, grad.contiguous())


class _AllGather(torch.autograd.Function):
    """Concatenate every member's ``x`` along ``dim``; the backward, under
    the same convention, sums the gradient over the group and keeps this
    member's part."""

    @staticmethod
    def forward(ctx, group, dim, x):
        ctx.group, ctx.dim, ctx.size = group, dim, x.shape[dim]
        if isinstance(group, CountedGroup):
            ctx.rank = 0
            out = torch.cat([x] * group.size, dim=dim)
            group.record("all-gather", out)
            return out
        ctx.rank = dist.get_rank(group)
        parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
        dist.all_gather(parts, x.contiguous(), group=group)
        return torch.cat(parts, dim=dim)

    @staticmethod
    def backward(ctx, grad):
        g = _AllReduce.apply(ctx.group, grad.contiguous())
        return None, None, g.narrow(ctx.dim, ctx.rank * ctx.size, ctx.size)


def sum_over(x, mesh, axes):
    """Sum ``x`` over the processes of ``axes`` (one group at a time)."""
    for a in (axes if isinstance(axes, tuple) else (axes,)):
        x = _AllReduce.apply(mesh.get_group(a), x)
    return x


@torch.no_grad()
def max_over(x, mesh, axes):
    """The elementwise maximum of ``x`` over the processes of ``axes`` (not
    differentiable)."""
    out = x.clone()
    for a in (axes if isinstance(axes, tuple) else (axes,)):
        group = mesh.get_group(a)
        if isinstance(group, CountedGroup):
            group.record("all-reduce", out)
        else:
            dist.all_reduce(out, op=dist.ReduceOp.MAX, group=group)
    return out


def gather_over(x, mesh, axes, dim: int = 0):
    """Concatenate the processes' ``x`` along ``dim`` in the order of their
    flat coordinate over ``axes`` (the first axis outermost): the inverse
    of :func:`~.sharding.local_shard`'s cut."""
    axs = axes if isinstance(axes, tuple) else (axes,)
    dim = dim % x.dim()
    for a in reversed(axs):                  # innermost axis first
        x = _AllGather.apply(mesh.get_group(a), dim, x)
    return x


@torch.no_grad()
def gather_tree(tree, specs, mesh):
    """Every leaf whole from this process's slice under ``specs``: the
    inverse of :func:`~.sharding.local_shard`.  Every process calls it; a
    leaf replicated everywhere is returned as it is."""

    def whole(leaf, spec):
        for dim, e in enumerate(spec):
            if e is not None and axes_size(mesh, e) > 1:
                leaf = gather_over(leaf, mesh, e, dim)
        return leaf

    return map_tree(whole, tree, specs)


def model_rank() -> int:
    """This process's coordinate on the context's model axis (0 outside a
    context)."""
    ctx = _SHARD_CTX.get()
    return 0 if ctx is None else int(ctx[0].get_local_rank(ctx[2]))


def model_sum(x):
    ctx = _SHARD_CTX.get()
    return x if ctx is None else sum_over(x, ctx[0], ctx[2])


def model_gather(x, dim: int = -1):
    ctx = _SHARD_CTX.get()
    return x if ctx is None else gather_over(x, ctx[0], ctx[2], dim)


def model_columns(y, full: int):
    """``y`` with its last dim whole: gathered over ``model`` when it holds
    a column-cut slice of ``full`` (a product through a column-cut
    weight)."""
    return y if y.shape[-1] == full else model_gather(y, -1)


def model_column_range(y, full: int, start: int, width: int):
    """Columns ``[start, start + width)`` of the whole product of which
    ``y`` is this process's column-cut slice (of ``full`` columns): ``y``
    itself when its columns are exactly those, else cut from the whole
    product, gathered over ``model`` where ``y`` is a cut."""
    cols = y.shape[-1]
    if cols != full and cols == width and model_rank() * cols == start:
        return y
    y = model_columns(y, full)
    return y if width == full else y.narrow(-1, start, width)


def model_row_sum(y, rows: int, full: int):
    """``y``, a product through a weight holding ``rows`` of its ``full``
    input rows, summed over ``model`` when they are a cut."""
    return y if rows == full else model_sum(y)


def rows_split() -> bool:
    """True inside a context whose submission is row-split over its data
    axes."""
    ctx = _SHARD_CTX.get()
    return ctx is not None and bool(ctx[1])


def rows_gather(x, dim: int = 0):
    """The whole submission's rows from this process's slice."""
    if not rows_split():
        return x
    mesh, daxes, _ = _SHARD_CTX.get()
    return gather_over(x, mesh, daxes, dim)


def local_rows(x, dim: int = 0):
    """This process's contiguous slice of a whole submission's rows (the
    inverse of :func:`rows_gather`)."""
    if not rows_split():
        return x
    mesh, daxes, _ = _SHARD_CTX.get()
    n = axes_size(mesh, daxes)
    size = x.shape[dim] // n
    return x.narrow(dim, axes_coord(mesh, daxes) * size, size)

