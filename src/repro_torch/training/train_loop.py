"""The training driver: the update step with microbatch gradient
accumulation, optional int8 error-feedback gradient compression, async
checkpointing, auto-resume, straggler watchdog and failure injection.

Counterpart of ``src/repro/training/train_loop.py``, on one device.  The
reference jit-compiles its step and donates the state; here the step runs
eagerly and updates the state in place: ``state["params"]`` is
``lm.param_tree()``, the model's own parameters, so the trained ``LM`` can
be handed to ``ServeEngine`` as it is.  Gradients come from
``torch.autograd.grad`` (no ``.grad`` is left on the parameters).  The
reference's sharded state (``state_shardings`` / ``batch_sharding``) waits
for a later slice; ``distributed.sharding`` already holds the rules it
would follow (``param_specs``, ``zero1_specs``, ``batch_specs``).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Iterator, Optional

import torch

from ..models.model import LM
from . import checkpoint as ckpt
from .compression import compress_in_place, init_error_state
from .fault_tolerance import FailureInjector, StragglerWatchdog
from .optimizer import OptimConfig, apply_updates, init_opt_state
from .tree import copy_tree_, leaves, unflatten

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


class Trainer:
    def __init__(self, lm: LM, train_cfg: TrainConfig):
        self.lm = lm
        self.cfg = train_cfg
        self.watchdog = StragglerWatchdog()
        self.injector = FailureInjector()
        self._ckpt = (ckpt.AsyncCheckpointer(train_cfg.ckpt_dir)
                      if train_cfg.ckpt_dir and train_cfg.ckpt_async else None)

    # ------------------------------------------------------------------ state
    def init_state(self, generator: Optional[torch.Generator] = None) -> dict:
        """``{"params", "opt"}`` and, with compression, ``"err"``.  With a
        ``generator`` (on the model's device) the parameters are drawn anew
        from it, as ``LM(cfg, generator=...)`` draws them; without one the
        model keeps its parameters."""
        if generator is not None:
            fresh = LM(self.lm.cfg, device=self.lm.device, generator=generator)
            copy_tree_(self.lm.param_tree(), fresh.param_tree())
            del fresh
        params = self.lm.param_tree()
        state = {"params": params, "opt": init_opt_state(params)}
        if self.cfg.compression:
            state["err"] = init_error_state(params)
        return state

    # ------------------------------------------------------------------- step
    def step(self, state: dict, batch: dict) -> tuple[dict, dict]:
        """One optimizer step on ``batch`` (tensors on the model's device):
        ``grad_accum`` microbatches with their gradients summed in fp32 and
        divided by their number, then compression, then AdamW.  Returns
        ``(state, {"loss", "lr", "grad_norm"})``; ``state`` is updated in
        place."""
        cfg = self.cfg
        params = state["params"]
        flat_p = leaves(params)
        a = cfg.grad_accum
        if a > 1:
            micro = {k: v.reshape((a, v.shape[0] // a) + tuple(v.shape[1:]))
                     for k, v in batch.items()}
            grads = [torch.zeros(p.shape, dtype=f32, device=p.device) for p in flat_p]
            losses = []
            for i in range(a):
                loss, _ = self.lm.loss({k: v[i] for k, v in micro.items()})
                for acc, g in zip(grads, _grads(loss, flat_p)):
                    acc.add_(g)
                losses.append(loss.detach())
            div = torch.full((), float(a), dtype=f32, device=flat_p[0].device)
            for g in grads:
                g.div_(div)
            loss = torch.stack(losses).mean()
        else:
            loss, _ = self.lm.loss(batch)
            grads = list(_grads(loss, flat_p))
            loss = loss.detach()

        if cfg.compression:
            errs = leaves(state["err"])
            compress_in_place(grads, errs)
        _, state["opt"], info = apply_updates(params, unflatten(params, grads),
                                              state["opt"], cfg.optim)
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
        return {"state": state, "history": history}

    def _save(self, step: int, state: dict) -> None:
        if self._ckpt is not None:
            self._ckpt.submit(step, state)
        else:
            ckpt.save(self.cfg.ckpt_dir, step, state)
