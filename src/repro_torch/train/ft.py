"""Fault tolerance: the restartable training loop, failure injection and
straggler counts (a port of the JAX package's ``train/ft.py``).

The job's side of DFRS preemption and migration: DFRS pausing a job is the
job checkpointing and exiting; resuming or migrating it is the job
restarting from its newest checkpoint, on this card or another.
``run_restartable`` keeps that contract:

* an async checkpoint every ``ckpt_every`` steps and at the end;
* on (re)start, resume from the newest complete checkpoint; the data are
  a function of the step counter, so the trajectory is that of an
  uninterrupted run (bit for bit on the CPU; on the card within float
  noise where a kernel adds in a run-dependent order);
* a ``FailureInjector`` drives chaos tests (fail at given global steps);
* straggler detection: a per-step wall-time EMA; steps slower than
  ``straggler_factor`` x the EMA are counted and reported, for a cluster
  scheduler to re-place the job.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Tuple

from . import checkpoint as ckpt

__all__ = ["FailureInjector", "RunReport", "run_restartable",
           "StragglerStats", "InjectedFailure"]


class InjectedFailure(RuntimeError):
    """A simulated node failure."""


@dataclass
class FailureInjector:
    """Deterministic failure schedule: fail the run when the *global* step
    first reaches each entry of ``at_steps`` (each fires once)."""

    at_steps: Tuple[int, ...] = ()
    _fired: set = field(default_factory=set)

    def maybe_fail(self, step: int) -> None:
        if step in self._fired:
            return
        if step in self.at_steps:
            self._fired.add(step)
            raise InjectedFailure(f"injected node failure at step {step}")


@dataclass
class StragglerStats:
    ema: float = 0.0
    n_steps: int = 0
    n_stragglers: int = 0
    worst_ratio: float = 1.0

    def observe(self, dt: float, factor: float = 3.0, beta: float = 0.9
                ) -> bool:
        self.n_steps += 1
        if self.ema == 0.0:
            self.ema = dt
            return False
        is_straggler = dt > factor * self.ema
        if is_straggler:
            self.n_stragglers += 1
            self.worst_ratio = max(self.worst_ratio, dt / self.ema)
            # do not pollute the EMA with the outlier
        else:
            self.ema = beta * self.ema + (1 - beta) * dt
        return is_straggler


@dataclass
class RunReport:
    final_step: int
    n_restarts: int
    losses: List[float]
    straggler: StragglerStats
    restored_from: List[int]


def run_restartable(
    train_step: Callable[[Any, Any], Tuple[Any, Dict]],
    init_state: Callable[[], Any],
    batch_for_step: Callable[[int], Any],
    total_steps: int,
    ckpt_dir: str,
    ckpt_every: int = 50,
    injector: Optional[FailureInjector] = None,
    max_restarts: int = 16,
    straggler_factor: float = 3.0,
) -> RunReport:
    """Run ``total_steps`` of training, surviving injected failures by
    restarting from the newest checkpoint."""
    losses: List[float] = []
    restored_from: List[int] = []
    strag = StragglerStats()
    restarts = 0

    while True:
        # ---- (re)start: restore or init ---------------------------------
        state = init_state()
        start = ckpt.latest_step(ckpt_dir)
        if start is not None:
            _, state, _ = ckpt.restore(ckpt_dir, template=state)
            restored_from.append(start)
            step = start
        else:
            step = 0
        try:
            while step < total_steps:
                if injector is not None:
                    injector.maybe_fail(step)
                t0 = time.perf_counter()
                state, metrics = train_step(state, batch_for_step(step))
                loss = float(metrics["loss"])      # waits for the step
                dt = time.perf_counter() - t0
                strag.observe(dt, straggler_factor)
                losses.append(loss)
                step += 1
                if step % ckpt_every == 0 or step == total_steps:
                    ckpt.save_async(ckpt_dir, step, state,
                                    metadata={"loss": loss})
            ckpt.wait_pending()
            return RunReport(step, restarts, losses, strag, restored_from)
        except InjectedFailure:
            restarts += 1
            ckpt.wait_pending()
            if restarts > max_restarts:
                raise
