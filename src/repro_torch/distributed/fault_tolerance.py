"""Fault tolerance: checkpoint/restart loop with failure injection.

Counterpart of ``repro/distributed/fault_tolerance.py``.  On a real cluster
a node failure kills the process; recovery = restart the job and restore
the latest checkpoint (optionally onto other devices, since
``CheckpointManager.restore`` places leaves on load).  This module
simulates exactly that control flow so it can be exercised in tests:

    runner = FaultTolerantRunner(step_fn, ckpt_manager, save_every=20)
    state = runner.run(state, data_iter, n_steps,
                       failure=SimulatedFailure(at_steps=(57, 123)))

``step_fn(state, batch) -> (state, metrics)``.  When a failure fires, the
in-memory state is discarded (as it would be on a real crash) and restored
from the last checkpoint; steps re-run from there.  The runner also feeds the
straggler watchdog and keeps restart statistics.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

from .. import obs
from ..checkpoint import CheckpointManager

from .straggler import StragglerWatchdog


class SimulatedFailure(Exception):
    """Raised mid-training to emulate a node crash."""

    def __init__(self, at_steps=(), probability: float = 0.0, seed: int = 0):
        super().__init__("simulated node failure")
        self.at_steps = set(at_steps)
        self.probability = probability
        import random

        self._rng = random.Random(seed)

    def should_fire(self, step: int) -> bool:
        if step in self.at_steps:
            self.at_steps.discard(step)
            return True
        return self.probability > 0 and self._rng.random() < self.probability


@dataclasses.dataclass
class RunStats:
    steps_completed: int = 0
    restarts: int = 0
    wasted_steps: int = 0
    straggler_events: int = 0

    def as_dict(self) -> dict:
        """Plain-dict view so benches and serving loops log it uniformly."""
        return dataclasses.asdict(self)


class FaultTolerantRunner:
    def __init__(
        self,
        step_fn: Callable,
        manager: CheckpointManager,
        save_every: int = 20,
        max_restarts: int = 10,
    ):
        self.step_fn = step_fn
        self.manager = manager
        self.save_every = save_every
        self.max_restarts = max_restarts
        self.watchdog = StragglerWatchdog()
        self.stats = RunStats()

    def run(
        self,
        state: Any,
        batches: Callable[[int], Any],
        n_steps: int,
        failure: SimulatedFailure | None = None,
        log_every: int = 0,
    ):
        """``batches(step)`` must be resumable by step (deterministic data)."""
        step = 0
        if self.manager.latest_step() is None:
            # step-0 checkpoint: a crash before the first save restarts from
            # the true initial state, not a half-mutated in-memory one
            self.manager.save(0, state)
            self.manager.wait()
        while step < n_steps:
            try:
                while step < n_steps:
                    if failure is not None and failure.should_fire(step):
                        raise failure
                    with obs.timer("train_step_ms") as t:
                        state, metrics = self.step_fn(state, batches(step))
                    dt = t.elapsed_s
                    if self.watchdog.record(step, dt):
                        self.stats.straggler_events += 1
                    if log_every and step % log_every == 0:
                        loss = metrics.get("loss") if isinstance(metrics, dict) else metrics
                        print(f"[train] step {step} loss {float(loss):.4f} ({dt*1e3:.0f} ms)")
                    step += 1
                    self.stats.steps_completed += 1
                    if step % self.save_every == 0:
                        self.manager.save(step, state)
            except SimulatedFailure:
                self.stats.restarts += 1
                if self.stats.restarts > self.max_restarts:
                    raise RuntimeError("too many restarts") from None
                self.manager.wait()
                state, restored_step = self.manager.restore(state)
                self.stats.wasted_steps += step - restored_step
                step = restored_step
                print(f"[train] RESTART #{self.stats.restarts} from step {restored_step}")
        self.manager.wait()
        if self.manager.latest_step() != step:
            # final checkpoint -- skipped when the in-loop save at
            # ``step % save_every == 0`` already wrote this exact state
            self.manager.save(step, state)
            self.manager.wait()
        return state
