"""Job / cluster-node model for DFRS (paper §2.2).

A job j consists of ``n_tasks`` identical tasks.  Each task has a *CPU need*
``cpu_need`` in (0, 1] (fraction of a node's CPU it can use when dedicated)
and a *memory requirement* ``mem_req`` in (0, 1] (hard, non-oversubscribable
fraction of node memory).  All tasks of a job receive the same instantaneous
CPU fraction, hence the same *yield* = allocated fraction / cpu_need.

The scheduler is non-clairvoyant: ``proc_time`` is carried on the spec for
simulation/bound purposes but MUST NOT be read by scheduling policies.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List

import numpy as np

__all__ = [
    "JobSpec",
    "NodePool",
    "RUNNING",
    "PAUSED",
    "PENDING",
    "COMPLETED",
    "CANCELLED",
]

PENDING = "pending"      # submitted, never-yet-placed or removed before start
RUNNING = "running"
PAUSED = "paused"        # was running, preempted to storage
COMPLETED = "completed"
CANCELLED = "cancelled"  # withdrawn by its owner; never counted in metrics


@dataclass
class JobSpec:
    """Static description of a job (the simulator input record)."""

    jid: int
    release: float           # r_j, submission time (s)
    proc_time: float         # p_j, dedicated execution time (s); non-clairvoyant!
    n_tasks: int
    cpu_need: float          # c_j in (0, 1]
    mem_req: float           # m_j in (0, 1]

    def __post_init__(self) -> None:
        if not (0.0 < self.cpu_need <= 1.0):
            raise ValueError(f"cpu_need must be in (0,1], got {self.cpu_need}")
        if not (0.0 < self.mem_req <= 1.0):
            raise ValueError(f"mem_req must be in (0,1], got {self.mem_req}")
        if self.n_tasks < 1:
            raise ValueError("n_tasks must be >= 1")
        if self.proc_time <= 0:
            raise ValueError("proc_time must be > 0")

    @property
    def total_work(self) -> float:
        """Total CPU-seconds of work: n_tasks * p_j * c_j."""
        return self.n_tasks * self.proc_time * self.cpu_need


class NodePool:
    """Tracks per-node CPU load (sum of needs of resident tasks) and free
    memory.  CPU may be oversubscribed (load > 1); memory never."""

    def __init__(self, n_nodes: int):
        self.n = int(n_nodes)
        self.load = np.zeros(self.n)       # sum of cpu_need of tasks
        self.mem_free = np.ones(self.n)

    def copy(self) -> "NodePool":
        c = NodePool(self.n)
        c.load = self.load.copy()
        c.mem_free = self.mem_free.copy()
        return c

    def place(self, spec: JobSpec, mapping: List[int]) -> None:
        for node in mapping:
            self.load[node] += spec.cpu_need
            self.mem_free[node] -= spec.mem_req
        if (self.mem_free < -1e-9).any():
            raise RuntimeError("node memory oversubscribed")

    def remove(self, spec: JobSpec, mapping: List[int]) -> None:
        for node in mapping:
            self.load[node] -= spec.cpu_need
            self.mem_free[node] += spec.mem_req

    def masked_loads(self, mem_req: float) -> np.ndarray:
        """Fresh candidate array for greedy placement: per-node load with
        memory-infeasible nodes masked to +inf.  The caller owns the array
        and keeps it current with O(1) writes per placement instead of
        rebuilding the mask per task."""
        return np.where(self.mem_free >= mem_req - 1e-12, self.load, np.inf)
