"""Own copy of ``src/repro/training/fault_tolerance.py`` (pure Python, no JAX
in it; nothing left out).

Fault-tolerance machinery: straggler watchdog, failure injection, elastic
re-carve policy.

At 1000+ nodes the failure model is: (a) a host crashes -> the job restarts
from the newest committed checkpoint (train loop auto-resume, exercised by
tests/test_fault_tolerance.py with an injected crash); (b) a host is slow ->
the watchdog flags it from step-time statistics so the scheduler can swap in
a spare; (c) a pod drops for good -> ``elastic_plan`` recomputes the largest
runnable (data, model) mesh from the surviving device count and the data
pipeline re-shards by construction (batches are pure functions of
(seed, step, shard)).
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Optional


class SimulatedFailure(RuntimeError):
    """Injected crash for restart tests."""


@dataclass
class StragglerWatchdog:
    """Flags steps (or, with per-host timings, hosts) that exceed
    ``threshold`` x the running median step time."""

    threshold: float = 2.0
    window: int = 50
    times: list = field(default_factory=list)
    flagged: list = field(default_factory=list)
    _t0: Optional[float] = None

    def start(self) -> None:
        self._t0 = time.monotonic()

    def stop(self, step: int) -> float:
        dt = time.monotonic() - self._t0
        self.times.append(dt)
        if len(self.times) > self.window:
            self.times.pop(0)
        med = sorted(self.times)[len(self.times) // 2]
        if len(self.times) >= 5 and dt > self.threshold * med:
            self.flagged.append((step, dt, med))
        return dt

    @property
    def median(self) -> float:
        return sorted(self.times)[len(self.times) // 2] if self.times else 0.0


@dataclass(frozen=True)
class ElasticPlan:
    data: int
    model: int
    dropped_hosts: int

    @property
    def n_devices(self) -> int:
        return self.data * self.model


def elastic_plan(n_alive: int, model_parallel: int,
                 min_data: int = 1) -> ElasticPlan:
    """Largest (data, model) mesh from surviving devices, keeping the model
    axis intact (params are sharded over it; reshaping it would re-shard
    every weight, while shrinking the data axis only changes batch layout)."""
    if n_alive < model_parallel * min_data:
        raise RuntimeError(
            f"{n_alive} devices cannot host model_parallel={model_parallel}")
    data = n_alive // model_parallel
    # largest power-of-two data axis keeps per-shard batch divisibility
    p = 1
    while p * 2 <= data:
        p *= 2
    return ElasticPlan(data=p, model=model_parallel,
                       dropped_hosts=n_alive - p * model_parallel)


@dataclass
class FailureInjector:
    """Deterministically crash at a given step (tests / chaos drills)."""

    crash_at_step: Optional[int] = None
    fired: bool = False

    def maybe_fail(self, step: int) -> None:
        if (self.crash_at_step is not None and step == self.crash_at_step
                and not self.fired):
            self.fired = True
            raise SimulatedFailure(f"injected failure at step {step}")
