"""Int8 error-feedback gradient compression (distributed-optimization trick).

Counterpart of ``src/repro/training/compression.py``.  Gradients are
quantised to int8 with one fp32 scale per leaf; the quantisation residual is
kept in an fp32 error state and added back the next step (Karimireddy et al.
'19).  :func:`compress_tree` / :func:`decompress_tree` /
:func:`compressed_grads` are the reference's pure transforms, equal to it in
fp32.  :func:`compress_in_place` is the same arithmetic leaf by leaf with the
error state updated in place and each gradient replaced as it goes, which
the ``Trainer`` uses: at minicpm-2b's size a second error state or a second
set of fp32 gradients would be 11 GB each.  :func:`ef_allreduce` is the
explicit compressed all-reduce of one leaf over a mesh's data axes.
"""
from __future__ import annotations

import torch

from ..distributed.context import max_over, sum_over
from ..distributed.sharding import axes_size
from .tree import leaves, map_tree, unflatten

f32 = torch.float32


def init_error_state(params):
    return map_tree(lambda p: torch.zeros(p.shape, dtype=f32, device=p.device), params)


def _quantize_(gf, reduce_max=None):
    """gf (fp32, the gradient plus the old error) is overwritten with the new
    error.  Returns (q int8, scale fp32 0-dim, the dequantised gradient).
    ``reduce_max`` takes ``gf``'s largest magnitude to the whole leaf's, for
    a leaf of which ``gf`` is one process's slice."""
    amax = gf.abs().max()
    if reduce_max is not None:
        amax = reduce_max(amax)
    scale = torch.clamp(amax, min=1e-12) / torch.full((), 127.0, dtype=f32,
                                                      device=gf.device)
    deq = torch.round(gf / scale).clamp_(-127, 127)
    q = deq.to(torch.int8)
    torch.mul(q, scale, out=deq)
    gf.sub_(deq)
    return q, scale, deq


def compress_leaf(g, err):
    """Returns (q int8, scale fp32 scalar, new_err)."""
    gf = g.float() + err
    q, scale, _ = _quantize_(gf)
    return q, scale, gf


def compress_tree(grads, err_state):
    out = [compress_leaf(g, e) for g, e in zip(leaves(grads), leaves(err_state))]
    return tuple(unflatten(grads, [o[i] for o in out]) for i in range(3))


def decompress_tree(qs, scales, like=None):
    out = map_tree(lambda q, s: q.float() * s, qs, scales)
    if like is not None:
        out = map_tree(lambda o, ref: o.to(ref.dtype), out, like)
    return out


def compressed_grads(grads, err_state):
    """grads -> (dequantized grads, new error state): the train-loop hook."""
    qs, scales, errs = compress_tree(grads, err_state)
    return decompress_tree(qs, scales, like=grads), errs


@torch.no_grad()
def compress_in_place(grads: list, errs: list, reduce_max=None) -> None:
    """:func:`compressed_grads` on the leaf lists of a gradient tree and its
    error state: ``errs[i]`` becomes the new error in place and ``grads[i]``
    is replaced by the dequantised gradient in its own dtype.  On a mesh,
    ``reduce_max[i]`` takes leaf ``i``'s largest magnitude over the
    processes that hold its other slices, so that its scale is the whole
    leaf's, as the reference compresses the global gradient."""
    for i, (g, e) in enumerate(zip(grads, errs)):
        e.add_(g)                          # g in fp32 + err
        grads[i] = _quantize_(e, reduce_max and reduce_max[i])[2].to(g.dtype)
        del g


@torch.no_grad()
def ef_allreduce(mesh, axis_names, x_q, scale):
    """Explicit compressed all-reduce of one leaf over ``axis_names`` of
    ``mesh`` (every process passes its own int8 ``x_q`` and fp32
    ``scale``, a 0-dim or per-element tensor): the payload widened to
    int32 and summed, the scales' maximum taken, then ``acc * s_max / n``
    with ``n`` the number of processes summed over.  The wire format is int8
    (the int32 widening models the accumulator); on a 1-wide axis this is
    exactly ``x_q * scale``."""
    axes = tuple(axis_names)
    n = axes_size(mesh, axes)
    acc = sum_over(x_q.to(torch.int32), mesh, axes)
    return acc.to(f32) * max_over(scale.to(f32), mesh, axes) / n
