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
from typing import Dict, List, Optional

import numpy as np

__all__ = [
    "JobSpec",
    "JobState",
    "NodePool",
    "rebuild_pool",
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


@dataclass
class JobState:
    """Dynamic, scheduler-visible state of a submitted job (the per-job
    record of the host oracle; the engine keeps the same fields as
    columns, :mod:`repro_torch.core.state`)."""

    spec: JobSpec
    status: str = PENDING
    vt: float = 0.0                      # virtual time (integral of yield)
    yld: float = 0.0                     # current yield in [0, 1]
    mapping: Optional[List[int]] = None  # node id per task, len n_tasks
    penalty_until: float = -np.inf       # zero progress until then
    completed_at: Optional[float] = None
    n_pmtn: int = 0
    n_mig: int = 0
    started_once: bool = False

    # ---- scheduler-visible quantities (no proc_time!) -------------------
    def flow_time(self, now: float) -> float:
        return now - self.spec.release

    def priority(self, now: float) -> float:
        """flow_time / virtual_time**2 (paper §4.1); +inf when vt == 0."""
        if self.vt <= 0.0:
            return np.inf
        return self.flow_time(now) / (self.vt * self.vt)

    def priority_key(self, now: float):
        """Sort key: larger = higher priority; ties by submission order
        (earlier submission wins, §4.1)."""
        return (self.priority(now), -self.spec.jid)

    # ---- simulator-side quantities --------------------------------------
    def remaining_vt(self) -> float:
        return self.spec.proc_time - self.vt

    @property
    def is_running(self) -> bool:
        return self.status == RUNNING


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

    def max_load(self) -> float:
        return float(self.load.max()) if self.n else 0.0

    def fits(self, spec: JobSpec, node: int) -> bool:
        return self.mem_free[node] >= spec.mem_req - 1e-12

    def masked_loads(self, mem_req: float) -> np.ndarray:
        """Fresh candidate array for greedy placement: per-node load with
        memory-infeasible nodes masked to +inf.  The caller owns the array
        and keeps it current with O(1) writes per placement instead of
        rebuilding the mask per task."""
        return np.where(self.mem_free >= mem_req - 1e-12, self.load, np.inf)


def rebuild_pool(n_nodes: int, jobs: Dict[int, JobState]) -> NodePool:
    """Construct a NodePool from the mappings of all running jobs."""
    pool = NodePool(n_nodes)
    for js in jobs.values():
        if js.status == RUNNING and js.mapping is not None:
            pool.place(js.spec, js.mapping)
    return pool
