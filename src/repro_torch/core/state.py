"""Structure-of-arrays job state for the scheduling engine.

``EngineState`` keeps every per-job quantity the hot loop touches —
release / proc_time / vt / yield / status / penalty_until — in flat NumPy
arrays indexed by a dense job index (arrival order), so the fluid-progress
advance and the next-event computation are single vectorized expressions.
Task→node mappings stay as per-job lists (ragged, policy-produced) in
``mappings``.

Policy modules (``core.greedy``, ``core.mcb8``, ``sched.components``) read
jobs through ``JobView``: a zero-copy proxy whose reads/writes go straight
to the arrays.

``EngineState.from_trace`` is the array-native constructor: a columnar
:class:`repro_torch.workloads.trace.Trace` shares its layout with this
state, so the hot-loop arrays ingest whole columns with no per-spec loop.

Scale model (long streamed logs):

* Arrays live in geometrically doubled capacity buffers; the public
  attributes are length-``n`` views, so online ``extend`` is amortized
  O(1) per job instead of a full reallocation per batch.
* The running / in-system index sets are maintained incrementally by
  ``set_status`` (sorted lists mirroring ``np.nonzero`` output exactly),
  so every hot-loop scan is O(active), not O(jobs ever submitted).
* ``compact()`` evicts COMPLETED/CANCELLED rows from the SoA arrays, the
  view list, and the node-incidence CSR, folding the per-job quantities
  ``Engine._result`` needs into the append-only :class:`RetiredLog`.
  Merged back in global-arrival order, the retired log reproduces the
  uncompacted metric accumulation **bit for bit** (same float op order).
"""
from __future__ import annotations

from bisect import bisect_left
from functools import lru_cache
from typing import Dict, List, Optional, Sequence

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
    "RetiredLog",
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

# per-job SoA columns managed by the capacity buffers (order is the
# copy/compact order; values never depend on it)
_COLS = (
    ("proc_time", np.float64),
    ("proc_truth", np.float64),
    ("cpu_need", np.float64),
    ("demand", np.float64),
    ("vt", np.float64),
    ("yld", np.float64),
    ("penalty_until", np.float64),
    ("completed_at", np.float64),
    ("status", np.int8),
    ("n_pmtn", np.int64),
    ("n_mig", np.int64),
    ("gidx", np.int64),
)


class JobView:
    """Job object view over one row of an ``EngineState``.

    Provides exactly the attributes/methods the policy modules read
    (``spec``, ``vt``, ``yld``, ``status``, ``mapping``, ``penalty_until``,
    ``priority_key`` …); assignments write through to the arrays.

    ``i`` is the *dense* row index and is rewritten in place by
    ``EngineState.compact`` — holders keep their object reference (batch
    queues, snapshots-in-progress) and never see a stale row.
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
        vt = self.vt
        if vt <= 0.0:
            return np.inf
        return self.flow_time(now) / (vt * vt)

    def priority_key(self, now: float):
        return (self.priority(now), -self.spec.jid)

    # ---- simulator-side quantities --------------------------------------
    def remaining_vt(self) -> float:
        # estimate-based (policies never see the truth column); the job
        # may run past its estimate, so clamp at zero
        return max(0.0, self.spec.proc_time - self.vt)

    @property
    def proc_truth(self) -> float:
        """Executed processing time — engine-side only; policies must keep
        reading ``spec.proc_time`` (the non-clairvoyant estimate)."""
        return float(self._st.proc_truth[self.i])

    @property
    def is_running(self) -> bool:
        return int(self._st.status[self.i]) == S_RUNNING


class RetiredLog:
    """Streaming per-job accumulators for rows evicted by ``compact()``.

    Stores, per retired job, exactly the raw inputs ``Engine._result``
    needs — global arrival index, jid, release, completion time (NaN marks
    cancelled), executed processing time, and the precomputed work term
    ``n_tasks * proc_truth * cpu_need`` (that exact multiply order) — so
    the final metrics can be re-accumulated in the original global order
    with bit-identical float arithmetic.
    """

    _RCOLS = (
        ("gidx", np.int64),
        ("jid", np.int64),
        ("release", np.float64),
        ("completed_at", np.float64),
        ("proc_truth", np.float64),
        ("work", np.float64),
    )

    __slots__ = ("_n", "_cap", "_bufs", "n_cancelled", "n_noisy",
                 "_jid_sorted", "_jid_dirty")

    def __init__(self) -> None:
        self._n = 0
        self._cap = 0
        self._bufs: Dict[str, np.ndarray] = {
            name: np.empty(0, dtype=dt) for name, dt in self._RCOLS}
        self.n_cancelled = 0
        self.n_noisy = 0
        self._jid_sorted = np.empty(0, dtype=np.int64)
        self._jid_dirty = False

    def __len__(self) -> int:
        return self._n

    @property
    def n_completed(self) -> int:
        return self._n - self.n_cancelled

    def col(self, name: str) -> np.ndarray:
        return self._bufs[name][: self._n]

    def _ensure(self, need: int) -> None:
        if need <= self._cap:
            return
        cap = max(need, 2 * self._cap, 1024)
        for name, dt in self._RCOLS:
            buf = np.empty(cap, dtype=dt)
            buf[: self._n] = self._bufs[name][: self._n]
            self._bufs[name] = buf
        self._cap = cap

    def append(self, st: "EngineState", idx: np.ndarray) -> None:
        """Fold the (about-to-be-evicted) rows ``idx`` of ``st`` in."""
        k = int(idx.shape[0])
        if k == 0:
            return
        self._ensure(self._n + k)
        n0, n1 = self._n, self._n + k
        b = self._bufs
        b["gidx"][n0:n1] = st.gidx[idx]
        b["completed_at"][n0:n1] = st.completed_at[idx]
        b["proc_truth"][n0:n1] = st.proc_truth[idx]
        jid = b["jid"]
        rel = b["release"]
        wrk = b["work"]
        pt = st.proc_truth
        est = st.proc_time
        status = st.status
        nc = nz = 0
        for j, i in enumerate(idx.tolist()):
            s = st.specs[i]
            jid[n0 + j] = s.jid
            rel[n0 + j] = s.release
            if int(status[i]) == S_CANCELLED:
                wrk[n0 + j] = 0.0
                nc += 1
            else:
                # exact op order of Engine._result's total_work term
                wrk[n0 + j] = s.n_tasks * float(pt[i]) * s.cpu_need
            if pt[i] != est[i]:
                nz += 1
        self.n_cancelled += nc
        self.n_noisy += nz
        self._n = n1
        self._jid_dirty = True

    def contains(self, jids: Sequence[int]) -> List[int]:
        """Subset of ``jids`` already retired (for submit dup-checks)."""
        if self._n == 0:
            return []
        if self._jid_dirty:
            # stable sort exploits the sorted-runs structure of merged logs
            self._jid_sorted = np.sort(self.col("jid"), kind="stable")
            self._jid_dirty = False
        q = np.asarray(list(jids), dtype=np.int64)
        if q.size == 0:
            return []
        srt = self._jid_sorted
        pos = np.minimum(np.searchsorted(srt, q), srt.size - 1)
        return [int(x) for x in q[srt[pos] == q]]

    # ---- snapshot plumbing ----------------------------------------------
    def payload(self) -> dict:
        out = {name: self.col(name).tolist() for name, _ in self._RCOLS}
        out["n_cancelled"] = int(self.n_cancelled)
        out["n_noisy"] = int(self.n_noisy)
        return out

    @classmethod
    def from_payload(cls, payload: dict) -> "RetiredLog":
        log = cls()
        n = len(payload["gidx"])
        log._ensure(n)
        for name, dt in cls._RCOLS:
            log._bufs[name][:n] = np.asarray(payload[name], dtype=dt)
        log._n = n
        log.n_cancelled = int(payload["n_cancelled"])
        log.n_noisy = int(payload.get("n_noisy", 0))
        log._jid_dirty = True
        return log


def _sorted_add(lst: List[int], i: int) -> None:
    """Duplicate-safe insort (tolerates out-of-band status-array writes:
    the sets then stay merely incomplete, never corrupted)."""
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
    Under compaction the *global* arrival index lives in ``gidx`` (strictly
    increasing over the live rows) while the dense index stays contiguous.
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
        truth = getattr(trace, "proc_truth", None)
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
        self.gidx = np.arange(n, dtype=np.int64)
        self.mappings: List[Optional[List[int]]] = [None] * n
        self.views = [JobView(self, i) for i in range(n)]

        # lifetime accounting that survives compaction
        self.n_total = n                       # jobs ever submitted
        self.first_release = min(
            (s.release for s in self.specs), default=np.inf)
        self.retired = RetiredLog()

        # adopt the freshly built arrays as capacity buffers (no copy);
        # extend() grows them geometrically from here
        self._cap = n
        self._bufs = {name: getattr(self, name) for name, _ in _COLS}
        self.grow_count = 0                    # buffer reallocations (tests)

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
        self.rebuild_index_sets()

    # ------------------------------------------------------------------ #
    # capacity management                                                 #
    # ------------------------------------------------------------------ #
    def _ensure_capacity(self, need: int) -> None:
        if need <= self._cap:
            return
        n = len(self.specs)
        cap = max(need, 2 * self._cap, 16)
        for name, dt in _COLS:
            buf = np.empty(cap, dtype=dt)
            buf[:n] = self._bufs[name][:n]
            self._bufs[name] = buf
        self._cap = cap
        self.grow_count += 1

    def _reslice(self, n: int) -> None:
        for name, _ in _COLS:
            setattr(self, name, self._bufs[name][:n])

    @property
    def capacity(self) -> int:
        return self._cap

    # ------------------------------------------------------------------ #
    # online ingest (streaming sessions)                                  #
    # ------------------------------------------------------------------ #
    def extend(self, specs: Sequence[JobSpec]) -> List[int]:
        """Append jobs to the SoA state mid-simulation (true online
        arrivals for :class:`repro_torch.sched.session.SimSession`).

        New rows start as ``S_NOT_ARRIVED``; the per-spec column values are
        computed by the exact expressions ``__init__`` uses, so a state
        grown in batches is bit-identical to one built in a single shot.
        Appends land in geometrically doubled buffers (amortized O(1) per
        job — no per-batch reallocation).  Returns the dense indices
        assigned to the new jobs.
        """
        specs = list(specs)
        if not specs:
            return []
        base = len(self.specs)
        k = len(specs)
        self._ensure_capacity(base + k)
        tail_proc = np.array([s.proc_time for s in specs], dtype=np.float64)
        tail_cpu = np.array([s.cpu_need for s in specs], dtype=np.float64)
        tail_dem = np.array(
            [s.n_tasks * s.cpu_need for s in specs], dtype=np.float64)
        b = self._bufs
        sl = slice(base, base + k)
        b["proc_time"][sl] = tail_proc
        # new rows start clairvoyant
        b["proc_truth"][sl] = tail_proc
        b["cpu_need"][sl] = tail_cpu
        b["demand"][sl] = tail_dem
        b["vt"][sl] = 0.0
        b["yld"][sl] = 0.0
        b["penalty_until"][sl] = -np.inf
        b["completed_at"][sl] = np.nan
        b["status"][sl] = S_NOT_ARRIVED
        b["n_pmtn"][sl] = 0
        b["n_mig"][sl] = 0
        b["gidx"][sl] = np.arange(
            self.n_total, self.n_total + k, dtype=np.int64)
        self._reslice(base + k)
        self.n_total += k
        self.first_release = min(
            self.first_release, min(s.release for s in specs))
        self.specs.extend(specs)
        self.mappings.extend([None] * k)
        self.views.extend(JobView(self, base + j) for j in range(k))
        self.inc.extend(tail_cpu)
        return list(range(base, base + k))

    # ------------------------------------------------------------------ #
    # incremental index sets                                              #
    # ------------------------------------------------------------------ #
    def set_status(self, i: int, code: int) -> None:
        """The single write path for status transitions: keeps the sorted
        running / in-system index lists (and retired count) in sync so the
        hot-loop scans stay O(active)."""
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
        if code >= S_COMPLETED and old < S_COMPLETED:
            self._n_retired += 1

    def set_demand(self, i: int, value: float) -> None:
        """Demand writes (job resize) invalidate the cached in-system sum."""
        self.demand[int(i)] = value
        self._dvers += 1

    def rebuild_index_sets(self) -> None:
        """Recompute the incremental sets from the status array — for
        wholesale writes (snapshot restore) and after compaction."""
        st = self.status
        self._run: List[int] = np.nonzero(st == S_RUNNING)[0].tolist()
        self._ins: List[int] = np.nonzero(
            (st > S_NOT_ARRIVED) & (st < S_COMPLETED))[0].tolist()
        self._run_arr: Optional[np.ndarray] = None
        self._ins_arr: Optional[np.ndarray] = None
        self._n_retired = int((st >= S_COMPLETED).sum())
        self._dvers += 1

    @property
    def n_retired_rows(self) -> int:
        """Live COMPLETED/CANCELLED rows currently evictable by compact()."""
        return self._n_retired

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
    # compaction                                                          #
    # ------------------------------------------------------------------ #
    def compact(self, protect: Optional[Sequence[int]] = None
                ) -> Optional[np.ndarray]:
        """Evict COMPLETED/CANCELLED rows from the SoA arrays.

        Their result-bearing quantities are folded into ``self.retired``
        (see :class:`RetiredLog`); surviving rows slide down in order, so
        both the dense index and ``gidx`` stay strictly increasing.  Every
        ``JobView`` of a surviving row has its ``.i`` rewritten *in place*
        (object identity preserved for policy queues), and the node
        incidence is remapped.  ``protect`` lists dense indices to keep
        regardless of status (e.g. rows with a pending arrival-heap entry,
        whose pop must still happen).

        Returns the old→new dense index map (``-1`` for evicted rows), or
        ``None`` if nothing was evictable.
        """
        status = self.status
        n = status.shape[0]
        keep_mask = status < S_COMPLETED
        if protect is not None and len(protect):
            keep_mask[np.asarray(protect, dtype=np.intp)] = True
        if bool(keep_mask.all()):
            return None
        keep = np.nonzero(keep_mask)[0]
        evict = np.nonzero(~keep_mask)[0]
        self.retired.append(self, evict)
        m = int(keep.shape[0])
        new_of_old = np.full(n, -1, dtype=np.int64)
        new_of_old[keep] = np.arange(m, dtype=np.int64)
        for name, _ in _COLS:
            buf = self._bufs[name]
            buf[:m] = buf[:n][keep]
        self._reslice(m)
        keep_list = keep.tolist()
        self.specs = [self.specs[i] for i in keep_list]
        self.mappings = [self.mappings[i] for i in keep_list]
        old_views = self.views
        views = []
        for newi, oldi in enumerate(keep_list):
            v = old_views[oldi]
            v.i = newi
            views.append(v)
        self.views = views
        self.inc.compact(keep, new_of_old)
        self.rebuild_index_sets()
        return new_of_old

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
        simulation times (multi-month traces, ``eps(now) > 1e-9``) the
        event loop cannot represent a later timestamp for it, so leaving
        it running would spin the loop at constant ``now`` forever.  For
        ``now`` below ~4e6 s the extra cut is unreachable (the projection
        adds at least ``rem > _EPS`` to ``now``), so small-trace runs are
        bit-identical with or without it.
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
            # the window, so u(t) is constant on [now, t_next) — exactly the
            # single segment the cut machinery below would produce.
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
