"""AdamW + learning-rate schedules (cosine and MiniCPM's WSD), no library
optimizer.

Counterpart of ``src/repro/training/optimizer.py``.  Moments are fp32
whatever the parameter dtype; the update is computed in fp32 and cast back;
global-norm clipping before the update; weight decay on every leaf with
``ndim >= 2`` (the stacked ``(n, D)`` norm scales included, as in the
reference).  ``schedule`` takes a Python int step and computes in fp32 as the
reference's traced version does.

Unlike the reference, which returns new arrays, :func:`apply_updates`
updates the parameters and both moments in place under ``torch.no_grad()``:
at minicpm-2b's size a second copy of the moments is 22 GB.  The scalars of
the update (lr, clip, bias corrections) are 0-dim fp32 tensors on the
parameters' device, so every division is a true fp32 division, as in the
reference.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from .tree import leaves, map_tree

f32 = torch.float32


@dataclass(frozen=True)
class OptimConfig:
    lr: float = 3e-4
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    schedule: str = "cosine"      # "cosine" | "wsd" | "const"
    warmup_steps: int = 100
    total_steps: int = 10_000
    # WSD (warmup-stable-decay, MiniCPM): stable until decay_start, then
    # exponential-ish decay over the final window.
    decay_start_frac: float = 0.9


def _t(x) -> torch.Tensor:
    return torch.tensor(x, dtype=f32)


def schedule(cfg: OptimConfig, step: int) -> torch.Tensor:
    """The learning rate at ``step``, a 0-dim fp32 CPU tensor."""
    s = _t(float(step))
    warm = torch.minimum(s / max(cfg.warmup_steps, 1), _t(1.0))
    if cfg.schedule == "const":
        return cfg.lr * warm
    t = torch.clamp((s - cfg.warmup_steps) / max(cfg.total_steps - cfg.warmup_steps, 1),
                    0.0, 1.0)
    if cfg.schedule == "cosine":
        return cfg.lr * warm * (0.1 + 0.9 * 0.5 * (1 + torch.cos(_t(math.pi) * t)))
    if cfg.schedule == "wsd":
        ds = cfg.decay_start_frac
        decay = torch.where(t < ds, _t(1.0),
                            torch.pow(_t(0.5), (t - ds) / max(1 - ds, 1e-6) * 4))
        return cfg.lr * warm * decay
    raise ValueError(cfg.schedule)


def init_opt_state(params) -> dict:
    """fp32 zero moments shaped like ``params`` (a tree) and step 0 (a 0-dim
    int32 CPU tensor)."""
    zeros = lambda p: torch.zeros(p.shape, dtype=f32, device=p.device)  # noqa: E731
    return {"m": map_tree(zeros, params), "v": map_tree(zeros, params),
            "step": torch.zeros((), dtype=torch.int32)}


def global_norm(tree) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(x.float())) for x in leaves(tree)))


def _is_matrix(p) -> bool:
    return p.ndim >= 2  # decay only matrices (norms/bias vectors exempt)


def update_scalars(cfg: OptimConfig, step: int, gnorm, dev) -> tuple:
    """``(lr, clip, c1, c2)`` of step ``step`` (the first is 1), 0-dim fp32
    tensors on ``dev``: the rate, the clip factor of the global norm
    ``gnorm`` and the two bias corrections."""
    lr = schedule(cfg, step).to(dev)
    clip = torch.clamp(torch.full((), cfg.grad_clip, dtype=f32, device=dev) / (gnorm + 1e-9),
                       max=1.0)
    c1 = (1.0 - torch.pow(_t(cfg.beta1), _t(float(step)))).to(dev)
    c2 = (1.0 - torch.pow(_t(cfg.beta2), _t(float(step)))).to(dev)
    return lr, clip, c1, c2


@torch.no_grad()
def adamw_leaf_(p, g, m, v, scalars: tuple, cfg: OptimConfig) -> None:
    """One AdamW update of the leaf ``p`` and its moments ``m`` / ``v``, in
    place, from its gradient ``g`` and :func:`update_scalars`."""
    lr, clip, c1, c2 = scalars
    b1, b2 = cfg.beta1, cfg.beta2
    g = g.float() * clip
    m.mul_(b1).add_(g * (1 - b1))
    v.mul_(b2).add_(torch.square(g).mul_(1 - b2))
    del g
    u = (m / c1).div_(torch.sqrt(v / c2).add_(cfg.eps))
    if cfg.weight_decay and _is_matrix(p):
        u.add_(cfg.weight_decay * p.float())
    u.mul_(lr)
    if p.dtype == f32:
        p.sub_(u)
    else:
        p.copy_(p.float().sub_(u))


@torch.no_grad()
def apply_updates(params, grads, opt_state, cfg: OptimConfig):
    """One AdamW step over the trees ``params`` (updated in place), ``grads``
    and ``opt_state`` (moments and step updated in place).  Returns
    ``(params, opt_state, {"lr", "grad_norm"})`` as the reference does."""
    flat_p = leaves(params)
    step = int(opt_state["step"]) + 1
    gnorm = global_norm(grads)
    scalars = update_scalars(cfg, step, gnorm, flat_p[0].device)
    for p, g, m, v in zip(flat_p, leaves(grads), leaves(opt_state["m"]),
                          leaves(opt_state["v"])):
        adamw_leaf_(p, g, m, v, scalars, cfg)
    opt_state["step"] = torch.tensor(step, dtype=torch.int32)
    return params, opt_state, {"lr": scalars[0], "grad_norm": gnorm}
