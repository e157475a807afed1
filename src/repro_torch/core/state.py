"""Structure-of-arrays job state for the scheduling engine.

``EngineState`` keeps every per-job quantity the hot loop touches —
release / proc_time / vt / yield / status / penalty_until — in flat NumPy
arrays indexed by a dense job index (arrival order), so the fluid-progress
advance and the next-event computation are single vectorized expressions.
Task→node mappings stay as per-job lists (ragged, policy-produced) in
``mappings``.

Policy modules (``core.greedy``, ``sched.components``) read jobs through
``JobView``: a zero-copy proxy whose reads/writes go straight to the arrays.

``EngineState.from_trace`` is the array-native constructor: a columnar
:class:`repro_torch.workloads.trace.Trace` shares its layout with this
state, so the hot-loop arrays ingest whole columns with no per-spec loop.
The running / in-system index sets are maintained incrementally by
``set_status`` (sorted lists mirroring ``np.nonzero`` output exactly), so
every hot-loop scan is O(active).
"""
from __future__ import annotations

from bisect import bisect_left
from functools import lru_cache
from typing import List, Optional, Sequence

import numpy as np

from .alloc_kernels import NodeIncidence
from .job import (
    CANCELLED,
    COMPLETED,
    PAUSED,
    PENDING,
    RUNNING,
    JobSpec,
    NodePool,
)

__all__ = [
    "EngineState",
    "JobView",
    "S_NOT_ARRIVED",
    "S_PENDING",
    "S_RUNNING",
    "S_PAUSED",
    "S_COMPLETED",
    "S_CANCELLED",
]

_EPS = 1e-9

# integer status codes (array-friendly); "in system" == 0 < status < COMPLETED
# (CANCELLED > COMPLETED, so cancelled jobs fall out of every in-system mask)
S_NOT_ARRIVED = 0
S_PENDING = 1
S_RUNNING = 2
S_PAUSED = 3
S_COMPLETED = 4
S_CANCELLED = 5

_STATUS_STR = {
    S_PENDING: PENDING,
    S_RUNNING: RUNNING,
    S_PAUSED: PAUSED,
    S_COMPLETED: COMPLETED,
    S_CANCELLED: CANCELLED,
}
_STATUS_CODE = {v: k for k, v in _STATUS_STR.items()}


class JobView:
    """Job object view over one row of an ``EngineState``.

    Provides exactly the attributes/methods the policy modules read
    (``spec``, ``vt``, ``yld``, ``status``, ``mapping``, ``penalty_until``,
    ``priority_key`` …); assignments write through to the arrays.
    """

    __slots__ = ("_st", "i", "spec")

    def __init__(self, st: "EngineState", i: int):
        self._st = st
        self.i = i
        self.spec = st.specs[i]

    # ---- array-backed fields -------------------------------------------
    @property
    def vt(self) -> float:
        return float(self._st.vt[self.i])

    @vt.setter
    def vt(self, v: float) -> None:
        self._st.vt[self.i] = v

    @property
    def yld(self) -> float:
        return float(self._st.yld[self.i])

    @yld.setter
    def yld(self, v: float) -> None:
        self._st.yld[self.i] = v

    @property
    def penalty_until(self) -> float:
        return float(self._st.penalty_until[self.i])

    @penalty_until.setter
    def penalty_until(self, v: float) -> None:
        self._st.penalty_until[self.i] = v

    @property
    def status(self) -> str:
        return _STATUS_STR[int(self._st.status[self.i])]

    @status.setter
    def status(self, v: str) -> None:
        self._st.set_status(self.i, _STATUS_CODE[v])

    @property
    def mapping(self) -> Optional[List[int]]:
        return self._st.mappings[self.i]

    @mapping.setter
    def mapping(self, v: Optional[List[int]]) -> None:
        self._st.mappings[self.i] = v

    @property
    def completed_at(self) -> Optional[float]:
        c = self._st.completed_at[self.i]
        return None if np.isnan(c) else float(c)

    @completed_at.setter
    def completed_at(self, v: float) -> None:
        self._st.completed_at[self.i] = v

    @property
    def n_pmtn(self) -> int:
        return int(self._st.n_pmtn[self.i])

    @n_pmtn.setter
    def n_pmtn(self, v: int) -> None:
        self._st.n_pmtn[self.i] = v

    @property
    def n_mig(self) -> int:
        return int(self._st.n_mig[self.i])

    @n_mig.setter
    def n_mig(self, v: int) -> None:
        self._st.n_mig[self.i] = v

    # ---- scheduler-visible quantities -----------------------------------
    def flow_time(self, now: float) -> float:
        return now - self.spec.release

    def priority(self, now: float) -> float:
        """flow_time / virtual_time**2 (paper §4.1); +inf when vt == 0."""
        vt = self.vt
        if vt <= 0.0:
            return np.inf
        return self.flow_time(now) / (vt * vt)

    def priority_key(self, now: float):
        """Sort key: larger = higher priority; ties by submission order
        (earlier submission wins, §4.1)."""
        return (self.priority(now), -self.spec.jid)


def _sorted_add(lst: List[int], i: int) -> None:
    p = bisect_left(lst, i)
    if p >= len(lst) or lst[p] != i:
        lst.insert(p, i)


def _sorted_drop(lst: List[int], i: int) -> None:
    p = bisect_left(lst, i)
    if p < len(lst) and lst[p] == i:
        del lst[p]


@lru_cache(maxsize=64)
def _specs_of(trace) -> tuple:
    """Policy-boundary ``JobSpec`` objects for a (sorted) trace, memoized by
    the trace's content fingerprint — the cells of a policy sweep share one
    spec list per trace instead of rebuilding the object graph per engine."""
    return tuple(trace.to_specs())


class EngineState:
    """All dynamic job state of one simulation, as flat arrays.

    The job index is arrival order (specs sorted by ``(release, jid)``);
    every policy-facing iteration below yields views in index order.
    """

    def __init__(self, specs: Sequence[JobSpec], n_nodes: int):
        self.specs = list(specs)
        self.proc_time = np.array([s.proc_time for s in self.specs], dtype=np.float64)
        # truth column: what the engine executes (the estimate, unless the
        # trace carries a separate truth column)
        self.proc_truth = self.proc_time.copy()
        self.cpu_need = np.array([s.cpu_need for s in self.specs], dtype=np.float64)
        # per-job demand, n_tasks * cpu_need — reused every advance
        self.demand = np.array(
            [s.n_tasks * s.cpu_need for s in self.specs], dtype=np.float64)
        self._init_dynamic(n_nodes)

    @classmethod
    def from_trace(cls, trace, n_nodes: int) -> "EngineState":
        """Array-native construction from a columnar Trace: the hot-loop
        arrays are whole-column copies (ordering by one lexsort), and the
        policy-facing ``JobSpec`` list is memoized per trace fingerprint."""
        trace = trace.sorted_by_release()
        st = cls.__new__(cls)
        st.specs = list(_specs_of(trace))
        st.proc_time = trace.proc_time.astype(np.float64)     # writable copy
        truth = trace.proc_truth
        st.proc_truth = (truth.astype(np.float64) if truth is not None
                         else st.proc_time.copy())
        st.cpu_need = trace.cpu_need.astype(np.float64)
        st.demand = trace.n_tasks * trace.cpu_need
        st._init_dynamic(n_nodes)
        return st

    def _init_dynamic(self, n_nodes: int) -> None:
        n = len(self.specs)
        self.vt = np.zeros(n)
        self.yld = np.zeros(n)
        self.penalty_until = np.full(n, -np.inf)
        self.completed_at = np.full(n, np.nan)
        self.status = np.full(n, S_NOT_ARRIVED, dtype=np.int8)
        self.n_pmtn = np.zeros(n, dtype=np.int64)
        self.n_mig = np.zeros(n, dtype=np.int64)
        self.mappings: List[Optional[List[int]]] = [None] * n
        self.views = [JobView(self, i) for i in range(n)]
        self.n_total = n
        self.first_release = min(
            (s.release for s in self.specs), default=np.inf)

        self.pool = NodePool(n_nodes)
        # job×node CSR incidence of the running tasks, kept consistent by
        # the engine on every start/pause/migrate/complete transition — the
        # §4.6 allocation kernels read it instead of rescanning mappings
        self.inc = NodeIncidence(n_nodes, self.cpu_need)
        self.alive = np.ones(n_nodes, dtype=bool)
        self.now = 0.0
        self.util_integral = 0.0       # ∫ useful allocation dt
        self.demand_integral = 0.0     # ∫ min(|P|, demand) dt

        # incremental index sets + demand-sum cache (O(active) hot loop)
        self._dvers = 0
        self._dsum: Optional[float] = None
        self._dsum_vers = -1
        st = self.status
        self._run: List[int] = np.nonzero(st == S_RUNNING)[0].tolist()
        self._ins: List[int] = np.nonzero(
            (st > S_NOT_ARRIVED) & (st < S_COMPLETED))[0].tolist()
        self._run_arr: Optional[np.ndarray] = None
        self._ins_arr: Optional[np.ndarray] = None

    # ------------------------------------------------------------------ #
    # incremental index sets                                              #
    # ------------------------------------------------------------------ #
    def set_status(self, i: int, code: int) -> None:
        """The single write path for status transitions: keeps the sorted
        running / in-system index lists in sync so the hot-loop scans stay
        O(active)."""
        i = int(i)
        old = int(self.status[i])
        if old == code:
            return
        self.status[i] = code
        was_in = S_NOT_ARRIVED < old < S_COMPLETED
        now_in = S_NOT_ARRIVED < code < S_COMPLETED
        if was_in != now_in:
            if now_in:
                _sorted_add(self._ins, i)
            else:
                _sorted_drop(self._ins, i)
            self._ins_arr = None
            self._dvers += 1
        was_run = old == S_RUNNING
        now_run = code == S_RUNNING
        if was_run != now_run:
            if now_run:
                _sorted_add(self._run, i)
            else:
                _sorted_drop(self._run, i)
            self._run_arr = None

    def set_demand(self, i: int, value: float) -> None:
        """Demand writes (job resize) invalidate the cached in-system sum."""
        self.demand[int(i)] = value
        self._dvers += 1

    def in_system_demand(self) -> float:
        """Cached ``demand[in_system].sum()`` — recomputed (by the exact
        same expression) only when the set or a demand entry changed."""
        if self._dsum is None or self._dsum_vers != self._dvers:
            ins = self.in_system_indices()
            self._dsum = float(self.demand[ins].sum())
            self._dsum_vers = self._dvers
        return self._dsum

    # ------------------------------------------------------------------ #
    # index helpers                                                       #
    # ------------------------------------------------------------------ #
    def running_indices(self) -> np.ndarray:
        arr = self._run_arr
        if arr is None:
            arr = self._run_arr = np.asarray(self._run, dtype=np.intp)
        return arr

    def in_system_indices(self) -> np.ndarray:
        arr = self._ins_arr
        if arr is None:
            arr = self._ins_arr = np.asarray(self._ins, dtype=np.intp)
        return arr

    def running(self) -> List[JobView]:
        return [self.views[i] for i in self.running_indices()]

    def uncompleted(self) -> List[JobView]:
        return [self.views[i] for i in self.in_system_indices()]

    def any_in_system(self) -> bool:
        return bool(self._ins)

    # ------------------------------------------------------------------ #
    # vectorized hot-loop kernels                                         #
    # ------------------------------------------------------------------ #
    def next_completion_time(self) -> float:
        """Earliest time any running job's virtual time reaches p_j."""
        run = self.running_indices()
        if run.size == 0:
            return np.inf
        yld = self.yld[run]
        ok = yld > _EPS
        if not ok.any():
            return np.inf
        run = run[ok]
        yld = yld[ok]
        t0 = np.maximum(self.now, self.penalty_until[run])
        t = t0 + (self.proc_truth[run] - self.vt[run]) / yld
        return float(t.min())

    def finished_running_indices(self) -> np.ndarray:
        """Running jobs whose remaining virtual time is exhausted.

        Besides the absolute ``rem <= _EPS`` cut, a job whose *projected
        completion time* rounds to ``<= now`` is finished too: at large
        simulation times (``eps(now) > 1e-9``) the event loop cannot
        represent a later timestamp for it, so leaving it running would spin
        the loop at constant ``now`` forever.
        """
        run = self.running_indices()
        if run.size == 0:
            return run
        yld = self.yld[run]
        rem = self.proc_truth[run] - self.vt[run]
        active = yld > _EPS
        done = (rem <= _EPS) & active
        if active.any():
            t0 = np.maximum(self.now, self.penalty_until[run])
            with np.errstate(divide="ignore", invalid="ignore"):
                proj = t0 + rem / yld
            done |= active & (proj <= self.now)
        return run[done]

    def advance(self, t_next: float) -> None:
        """Advance virtual times + utilization integrals to ``t_next``.

        u(t) is piecewise-constant except at penalty expiries inside the
        window; integrate exactly by splitting at those points.
        """
        if t_next <= self.now:
            return
        demand = self.in_system_demand()
        cap = float(self.alive.sum())
        run = self.running_indices()
        pen = self.penalty_until[run]
        inner_mask = (pen > self.now) & (pen < t_next)
        contrib = self.yld[run] * self.demand[run]
        if not inner_mask.any():
            # fast path (the common case): no penalty expiry strictly inside
            # the window, so u(t) is constant on [now, t_next)
            u = float(contrib[pen <= self.now + _EPS].sum())
            dt = t_next - self.now
            self.util_integral += u * dt
            self.demand_integral += min(cap, demand) * dt
        else:
            cuts = np.unique(np.concatenate(
                [[self.now, t_next], pen[inner_mask]]))
            for a, b in zip(cuts[:-1], cuts[1:]):
                u = float(contrib[pen <= a + _EPS].sum())
                self.util_integral += u * (b - a)
                self.demand_integral += min(cap, demand) * (b - a)
        eff = np.maximum(0.0, t_next - np.maximum(self.now, pen))
        self.vt[run] = np.minimum(
            self.proc_truth[run], self.vt[run] + self.yld[run] * eff
        )
        self.now = t_next
