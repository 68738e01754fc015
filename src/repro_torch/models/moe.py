"""Top-k MoE FFN (Mixtral-style) with sort-based, capacity-bounded dispatch.

Counterpart of ``src/repro/models/moe.py`` (``init_moe_params``,
``moe_ffn``, ``moe_ffn_sharded``, ``router_aux_loss``).  Tokens are routed with a stable sort over their expert
assignments plus scatter and gather, not a (T, E, C) one-hot dispatch
product.  Each expert takes at most ``capacity`` token slots, ranked in
row-major ``(token, choice)`` order across the whole batch; a slot over
capacity is dropped and the token's remaining gates are renormalised.  So a
row's output depends on its batch-mates, as in the reference.

Ties in the router logits go to the lower expert index, as ``lax.top_k``
and the Pallas gating kernel decide them (``torch.topk`` promises no order
on ties): :func:`route` sorts stably.

On a mesh the experts' F dim is split over ``model`` (with 8 experts on a
wide model axis, expert-sharding would pad), so every process runs every
expert on its F slice and the products are summed over ``model``.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from ..distributed.context import sum_over
from .config import MoESpec
from .layers import stacked_dense_init


def init_moe_params(gen: torch.Generator, n: int, d_model: int, d_ff: int,
                    spec: MoESpec, dtype, device) -> dict:
    """``n`` stacked layers: router (n, D, E), experts (n, E, D, F) and
    (n, E, F, D), with the reference's standard deviations."""
    e = spec.n_experts

    def experts(d_in, d_out):
        w = torch.randn((n, e, d_in, d_out), generator=gen, device=device,
                        dtype=torch.float32)
        return (w / math.sqrt(d_in)).to(dtype)

    return {
        "router": stacked_dense_init(gen, n, d_model, e, dtype, device),
        "w_gate": experts(d_model, d_ff),
        "w_up": experts(d_model, d_ff),
        "w_down": experts(d_ff, d_model),
    }


def route(logits, k: int):
    """Router logits (T, E) fp32 -> (top_idx (T, k) int64, gates (T, k)
    fp32, pos (T, k) int64): the top-k experts (lower index first on a
    tie), the softmax over their logits, and each slot's row-major arrival
    rank within its expert."""
    t, e = logits.shape
    top_vals, top_idx = torch.sort(logits, dim=-1, descending=True, stable=True)
    top_vals, top_idx = top_vals[:, :k], top_idx[:, :k]
    gates = torch.softmax(top_vals, dim=-1)
    flat_e = top_idx.reshape(-1)
    sorted_e, order = torch.sort(flat_e, stable=True)        # group by expert
    run_start = torch.searchsorted(sorted_e, sorted_e, side="left")
    pos_sorted = torch.arange(t * k, device=logits.device) - run_start
    pos = torch.empty_like(pos_sorted)
    pos[order] = pos_sorted                                   # undo the sort
    return top_idx, gates, pos.reshape(t, k)


def capacity_of(spec: MoESpec, n_tokens: int,
                capacity: Optional[int] = None) -> int:
    cap = capacity or int(math.ceil(spec.capacity_factor * spec.top_k
                                    * n_tokens / spec.n_experts))
    return max(cap, 1)


def moe_ffn(p, x, spec: MoESpec, capacity: Optional[int] = None):
    """x: (B, S, D) -> (B, S, D).  Router in fp32; top-k softmax-of-topk."""
    btype = x.dtype
    b, s, d = x.shape
    e, k = spec.n_experts, spec.top_k
    t = b * s
    xt = x.reshape(t, d)

    logits = (xt @ p["router"]).float()                      # (T, E)
    top_idx, gates, pos = route(logits, k)
    cap = capacity_of(spec, t, capacity)
    flat_e, pos = top_idx.reshape(-1), pos.reshape(-1)
    keep = pos < cap
    tok_of = torch.arange(t, device=x.device).repeat_interleave(k)
    safe_pos = torch.where(keep, pos, cap - 1)

    # The scatter-adds below stand in for the reference's ``.at[].add`` and
    # are exact in any order: a kept (expert, slot) pair is unique, a dropped
    # one adds an exact zero, and each token of ``combined`` receives at most
    # top_k = 2 non-zero terms (a + b == b + a in floating point).
    slot = flat_e * cap + safe_pos
    disp = torch.zeros((e * cap, d), dtype=btype, device=x.device)
    disp.index_add_(0, slot, torch.where(keep[:, None], xt[tok_of],
                                         torch.zeros((), dtype=btype,
                                                     device=x.device)))
    disp = disp.reshape(e, cap, d)

    h = F.silu(torch.einsum("ecd,edf->ecf", disp, p["w_gate"]))
    h = h * torch.einsum("ecd,edf->ecf", disp, p["w_up"])
    out_e = torch.einsum("ecf,efd->ecd", h, p["w_down"]).reshape(e * cap, d)

    gathered = torch.where(keep[:, None], out_e[slot],
                           torch.zeros((), dtype=btype, device=x.device))
    gk = (gates.reshape(-1) * keep).to(btype)
    combined = torch.zeros((t, d), dtype=btype, device=x.device)
    combined.index_add_(0, tok_of, gathered * gk[:, None])

    # renormalise for dropped slots
    denom = torch.zeros((t,), dtype=torch.float32, device=x.device)
    denom.index_add_(0, tok_of, gk.float())
    combined = combined / denom.clamp_min(1e-9)[:, None].to(btype)
    return combined.reshape(b, s, d)


def moe_ffn_sharded(p, x, spec: MoESpec, mesh, dp_axes, model_axis: str):
    """Data-shard-local MoE dispatch (the reference's ``shard_map`` form).

    Each data shard dispatches its OWN tokens (``x``, this process's rows)
    into a local (E, C_local, D) buffer, C_local the capacity of the local
    token count (per-shard capacity, as production routers use), through
    its F slice of the experts (``p``'s ``w_gate`` / ``w_up`` (E, D, F/m),
    ``w_down`` (E, F/m, D)); only the F contraction is summed over
    ``model_axis``.  ``dp_axes`` are the axes the rows are split over (the
    dispatch needs nothing of them)."""
    del dp_axes
    return sum_over(moe_ffn(p, x, spec), mesh, model_axis)


def router_aux_loss(p, x, spec: MoESpec) -> torch.Tensor:
    """Load-balancing auxiliary loss (Switch-style): ``E * sum(f_e * p_e)``,
    with ``f_e`` the share of tokens whose top-1 expert is e (the lower
    index on a tie) and ``p_e`` the mean router probability of e."""
    d = x.shape[-1]
    logits = (x.reshape(-1, d) @ p["router"]).float()
    probs = torch.softmax(logits, dim=-1)
    top1 = logits.argmax(dim=-1)
    frac = F.one_hot(top1, spec.n_experts).float().mean(dim=0)
    return spec.n_experts * torch.sum(frac * probs.mean(dim=0))
