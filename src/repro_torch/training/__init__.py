"""Counterpart of ``src/repro/training/``: AdamW with the cosine, WSD and
constant schedules, int8 error-feedback gradient compression, atomic
checkpoints in the reference's layout, the straggler watchdog and failure
injection, the eager ``Trainer`` (one device, or SPMD over a mesh with
ZeRO-1 / FSDP state) and ``compression.ef_allreduce``, the explicit int8
all-reduce over a mesh."""
from .optimizer import OptimConfig, apply_updates, init_opt_state, schedule
from .train_loop import TrainConfig, Trainer
from . import checkpoint, compression, fault_tolerance

__all__ = ["OptimConfig", "apply_updates", "init_opt_state", "schedule",
           "TrainConfig", "Trainer", "checkpoint", "compression",
           "fault_tolerance"]
