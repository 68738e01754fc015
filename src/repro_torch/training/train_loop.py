"""The training driver: the update step with microbatch gradient
accumulation, optional int8 error-feedback gradient compression, sharded
state, async checkpointing, auto-resume, straggler watchdog and failure
injection.

Counterpart of ``src/repro/training/train_loop.py``.  The reference
jit-compiles its step and donates the state; here the step runs eagerly and
updates the state in place: ``state["params"]`` is the model's own
parameters (``lm.param_tree()``), so the trained ``LM`` can be handed to
``ServeEngine`` as it is.  Gradients come from ``torch.autograd.grad`` (no
``.grad`` is left on the parameters).

On a mesh (``Trainer(lm, cfg, mesh=, plan=)``, the counterpart of the
reference's ``state_shardings`` / ``batch_sharding``) the step is SPMD, one
process per device, every process running the same calls:

* ``state["params"]`` is ``lm.sharded(mesh, plan).param_tree()``, this
  process's slices under ``param_specs`` (a leaf the mesh does not cut is
  the model's own tensor, shared with ``lm``);
* each microbatch is taken first, then this process's rows of it over the
  data axes, so MoE capacity is ranked over the rows the reference ranks;
* the collectives' backward passes sum over their groups, which makes each
  local gradient that of the sum of every process's loss, and every model
  process holds the same loss: a leaf's gradient is summed over the axes it
  is replicated on and divided by the number of processes (the mean over
  the data axes, each element counted once);
* the global norm counts every element once (each leaf's squares summed
  over the axes it is cut on), and compression scales each leaf by its
  whole gradient's largest magnitude, as the reference's jit compresses the
  reduced global gradient;
* ``plan.zero1`` keeps the moments cut as ``zero1_specs`` says: each data
  process updates its slice of such a leaf and the updated slices are
  gathered; ``plan.fsdp`` keeps parameters, moments and error state cut
  over the data axes (the model gathers them per stack, ``LM._gathered``);
* checkpoints hold the gathered global tree, written by the process at
  coordinate 0 (byte-equal to the unsharded trainer's files), and are
  restored by slicing.

The same step runs on a ``distributed.context.CountingMesh`` over ``meta``
tensors: the dry-run's train cell (``launch/dryrun.py``).
"""
from __future__ import annotations

import contextlib
import math
from dataclasses import dataclass
from typing import Callable, Iterator, Optional

import torch
import torch.distributed as dist

from ..distributed.context import (gather_over, gather_tree, max_over,
                                   shard_context, sum_over)
from ..distributed.sharding import (P, ShardingPlan, axes_coord, axes_size,
                                    axis_names, batch_specs, data_axes,
                                    local_shape, local_shard, param_specs,
                                    zero1_specs)
from ..models.model import LM
from . import checkpoint as ckpt
from .compression import compress_in_place, init_error_state
from .fault_tolerance import FailureInjector, StragglerWatchdog
from .optimizer import (OptimConfig, adamw_leaf_, apply_updates,
                        init_opt_state, update_scalars)
from .tree import copy_tree_, leaves, map_tree, unflatten

f32 = torch.float32


def _grads(loss, flat_p):
    """d loss / d p for every leaf; zeros where a parameter does not reach
    the loss (``final_norm``, which ``LM.loss`` skips), as ``jax.grad``
    gives."""
    return torch.autograd.grad(loss, flat_p, allow_unused=True, materialize_grads=True)


@dataclass(frozen=True)
class TrainConfig:
    steps: int = 100
    log_every: int = 10
    ckpt_dir: Optional[str] = None
    ckpt_every: int = 50
    ckpt_async: bool = True
    grad_accum: int = 1            # microbatches per step
    compression: bool = False      # int8 error-feedback grads
    optim: OptimConfig = OptimConfig()


def _cut_axes(spec: P, mesh) -> tuple:
    """The axes (of size above 1) that ``spec`` cuts a leaf over."""
    out: list = []
    for e in spec:
        for a in (e if isinstance(e, tuple) else (e,)):
            if a is not None and axes_size(mesh, a) > 1:
                out.append(a)
    return tuple(out)


class Trainer:
    def __init__(self, lm: LM, train_cfg: TrainConfig, mesh=None,
                 plan: Optional[ShardingPlan] = None):
        self.cfg = train_cfg
        self.mesh = mesh
        self.watchdog = StragglerWatchdog()
        self.injector = FailureInjector()
        if mesh is None:
            self.lm = lm
        else:
            self.plan = plan or ShardingPlan()
            tree = lm.param_tree()
            # the global tree's shapes, for the specs and the moments' cuts
            self._global = map_tree(
                lambda t: torch.empty(t.shape, dtype=t.dtype, device="meta"), tree)
            self.lm = lm.sharded(mesh, self.plan)
            self.daxes = data_axes(mesh)
            self.pspecs = leaves(param_specs(tree, mesh, self.plan))
            self.ospecs = leaves(zero1_specs(self._global, unflatten(tree, self.pspecs),
                                             mesh, self.plan))
            self.n_procs = math.prod(axes_size(mesh, a) for a in axis_names(mesh))
            self.writer = all(mesh.get_local_rank(a) == 0 for a in axis_names(mesh))
        self._ckpt = (ckpt.AsyncCheckpointer(train_cfg.ckpt_dir)
                      if train_cfg.ckpt_dir and train_cfg.ckpt_async else None)

    # ------------------------------------------------------------------ state
    def init_state(self, generator: Optional[torch.Generator] = None) -> dict:
        """``{"params", "opt"}`` and, with compression, ``"err"``.  With a
        ``generator`` (on the model's device) the parameters are drawn anew
        from it, as ``LM(cfg, generator=...)`` draws them (on a mesh the
        whole model is drawn and this process's slices kept); without one
        the model keeps its parameters."""
        params = self.lm.param_tree()
        if generator is not None:
            fresh = LM(self.lm.cfg, device=self.lm.device, generator=generator).param_tree()
            if self.mesh is not None:
                fresh = local_shard(fresh, unflatten(fresh, self.pspecs), self.mesh)
            copy_tree_(params, fresh)
            del fresh
        if self.mesh is None:
            state = {"params": params, "opt": init_opt_state(params)}
        else:
            moments = unflatten(params, [
                torch.zeros(local_shape(g.shape, spec, self.mesh), dtype=f32,
                            device=self.lm.device)
                for g, spec in zip(leaves(self._global), self.ospecs)])
            state = {"params": params, "opt": {
                "m": moments, "v": map_tree(torch.zeros_like, moments),
                "step": torch.zeros((), dtype=torch.int32)}}
        if self.cfg.compression:
            state["err"] = init_error_state(params)
        return state

    def state_specs(self, state: dict) -> dict:
        """The spec of every leaf of a sharded ``state``."""
        params = state["params"]
        specs = {"params": unflatten(params, self.pspecs),
                 "opt": {"m": unflatten(params, self.ospecs),
                         "v": unflatten(params, self.ospecs), "step": P()}}
        if "err" in state:
            specs["err"] = unflatten(params, self.pspecs)
        return specs

    # ------------------------------------------------------------------- step
    def _context(self, batch: dict):
        """This process's rows of ``batch`` and the shard context to run the
        model in (rows split over the data axes where they divide)."""
        if self.mesh is None:
            return batch, contextlib.nullcontext()
        specs = batch_specs(batch, self.mesh)
        split = any(_cut_axes(s, self.mesh) for s in specs.values())
        rows = local_shard(batch, specs, self.mesh)
        return rows, shard_context(self.mesh, self.daxes if split else ())

    def _loss_and_grads(self, batch: dict, flat_p: list):
        """``grad_accum`` microbatches, gradients summed in fp32 and divided
        by their number; the loss is their mean."""
        a = self.cfg.grad_accum
        if a == 1:
            rows, sctx = self._context(batch)
            with sctx:
                loss, _ = self.lm.loss(rows)
                grads = list(_grads(loss, flat_p))
            return loss.detach(), grads
        micro = {k: v.reshape((a, v.shape[0] // a) + tuple(v.shape[1:]))
                 for k, v in batch.items()}
        grads = [torch.zeros(p.shape, dtype=f32, device=p.device) for p in flat_p]
        losses = []
        for i in range(a):
            rows, sctx = self._context({k: v[i] for k, v in micro.items()})
            with sctx:
                loss, _ = self.lm.loss(rows)
                for acc, g in zip(grads, _grads(loss, flat_p)):
                    acc.add_(g)
            losses.append(loss.detach())
        div = torch.full((), float(a), dtype=f32, device=flat_p[0].device)
        for g in grads:
            g.div_(div)
        return torch.stack(losses).mean(), grads

    @torch.no_grad()
    def _reduce(self, loss, grads: list):
        """Global loss and gradients from this process's: each gradient
        summed over the axes its leaf is replicated on, then divided by the
        number of processes; the loss averaged over the data axes."""
        mesh, n = self.mesh, self.n_procs
        daxes = tuple(a for a in self.daxes if axes_size(mesh, a) > 1)
        every = tuple(a for a in axis_names(mesh) if axes_size(mesh, a) > 1)
        for i, spec in enumerate(self.pspecs):
            cut = _cut_axes(spec, mesh)
            repl = tuple(a for a in every if a not in cut)
            if repl:
                grads[i] = sum_over(grads[i], mesh, repl)
            if n > 1:
                grads[i] = grads[i] / n
        if daxes:
            loss = sum_over(loss, mesh, daxes) / axes_size(mesh, daxes)
        return loss, grads

    @torch.no_grad()
    def _sharded_update(self, params, grads: list, opt: dict):
        """AdamW over this process's slices (see the module docstring)."""
        mesh = self.mesh
        flat_p = leaves(params)
        sq = [torch.sum(torch.square(g.float())) for g in grads]
        for i, spec in enumerate(self.pspecs):
            cut = _cut_axes(spec, mesh)
            if cut:
                sq[i] = sum_over(sq[i], mesh, cut)
        gnorm = torch.sqrt(sum(sq))
        step = int(opt["step"]) + 1
        scalars = update_scalars(self.cfg.optim, step, gnorm, flat_p[0].device)
        for p, g, m, v, pspec, ospec in zip(flat_p, grads, leaves(opt["m"]),
                                            leaves(opt["v"]), self.pspecs, self.ospecs):
            pspec = tuple(pspec) + (None,) * (p.dim() - len(pspec))
            zero = [(d, e) for d, (e, pe) in enumerate(zip(ospec, pspec))
                    if e is not None and pe is None and axes_size(mesh, e) > 1]
            if not zero:
                adamw_leaf_(p, g, m, v, scalars, self.cfg.optim)
                continue
            (dim, axes), = zero
            size = p.shape[dim] // axes_size(mesh, axes)
            start = axes_coord(mesh, axes) * size
            mine = p.narrow(dim, start, size)
            adamw_leaf_(mine, g.narrow(dim, start, size), m, v, scalars,
                        self.cfg.optim)
            p.copy_(gather_over(mine.contiguous(), mesh, axes, dim))
        opt["step"] = torch.tensor(step, dtype=torch.int32)
        return {"lr": scalars[0], "grad_norm": gnorm}

    def step(self, state: dict, batch: dict) -> tuple[dict, dict]:
        """One optimizer step on ``batch`` (tensors on the model's device;
        on a mesh the whole batch, of which each process takes its rows):
        ``grad_accum`` microbatches, then the reduction over the mesh, then
        compression, then AdamW.  Returns ``(state, {"loss", "lr",
        "grad_norm"})``; ``state`` is updated in place."""
        cfg = self.cfg
        params = state["params"]
        flat_p = leaves(params)
        loss, grads = self._loss_and_grads(batch, flat_p)
        if self.mesh is not None:
            loss, grads = self._reduce(loss, grads)
        if cfg.compression:
            reduce_max = None
            if self.mesh is not None:
                reduce_max = [
                    (lambda x, cut=cut: max_over(x, self.mesh, cut)) if cut else None
                    for cut in (_cut_axes(s, self.mesh) for s in self.pspecs)]
            compress_in_place(grads, leaves(state["err"]), reduce_max)
        if self.mesh is None:
            _, state["opt"], info = apply_updates(params, unflatten(params, grads),
                                                  state["opt"], cfg.optim)
        else:
            info = self._sharded_update(params, grads, state["opt"])
        del grads
        return state, {"loss": loss, **info}

    # -------------------------------------------------------------------- run
    def run(self, state: Optional[dict], batches: Iterator[dict],
            resume: bool = True,
            on_step: Optional[Callable[[int, dict], None]] = None) -> dict:
        """Runs to cfg.steps; auto-resumes from the newest committed
        checkpoint when ``resume``.  Returns {"state", "history"}."""
        cfg = self.cfg
        start = 0
        if resume and cfg.ckpt_dir:
            last = ckpt.latest_step(cfg.ckpt_dir)
            if last is not None:
                assert state is not None, "need a template state to restore into"
                restored, _ = ckpt.restore(cfg.ckpt_dir, last, state, device="cpu")
                if self.mesh is not None:
                    restored = local_shard(restored, self.state_specs(state), self.mesh)
                copy_tree_(state, restored)
                del restored
                start = last
        assert state is not None

        history: list[dict] = []
        it = iter(batches)
        # fast-forward the deterministic pipeline to the resume point
        for _ in range(start):
            next(it)
        dev = self.lm.device
        for step in range(start, cfg.steps):
            batch = {k: torch.as_tensor(v).to(dev) for k, v in next(it).items()}
            self.watchdog.start()
            state, metrics = self.step(state, batch)
            loss = float(metrics["loss"])
            dt = self.watchdog.stop(step)
            rec = {"step": step + 1, "loss": loss,
                   "lr": float(metrics["lr"]),
                   "grad_norm": float(metrics["grad_norm"]), "dt": dt}
            history.append(rec)
            if on_step:
                on_step(step + 1, rec)
            if cfg.log_every and (step + 1) % cfg.log_every == 0:
                print(f"step {step+1:5d} loss {loss:.4f} "
                      f"lr {rec['lr']:.2e} |g| {rec['grad_norm']:.3f} "
                      f"{dt*1e3:.0f}ms")
            if cfg.ckpt_dir and (step + 1) % cfg.ckpt_every == 0:
                self._save(step + 1, state)
            self.injector.maybe_fail(step + 1)  # after ckpt: worst-case drill
        if cfg.ckpt_dir:
            self._save(cfg.steps, state)
            if self._ckpt:
                self._ckpt.wait()
            if self.mesh is not None:
                dist.barrier()             # the checkpoint is committed for all
        return {"state": state, "history": history}

    def _save(self, step: int, state: dict) -> None:
        if self.mesh is not None:
            state = gather_tree(state, self.state_specs(state), self.mesh)
            if not self.writer:
                return
        if self._ckpt is not None:
            self._ckpt.submit(step, state)
        else:
            ckpt.save(self.cfg.ckpt_dir, step, state)
