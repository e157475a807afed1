"""Batched scenario sweeps: evaluate a grid of simulation cells on one device.

A :class:`Cell` is one (workload × policy × scenario) point — the workload
a declarative :class:`repro_torch.workloads.registry.WorkloadSpec`.
:func:`run_batched` runs every cell's engine in its own thread with a lane
of one :class:`~repro_torch.core.alloc_torch.LockstepDispatcher` as its
allocation backend: the driver thread collects every live lane's §4.6
request per scheduling round, pads them into one dense batch, and answers
the round with one lockstep water-filling on the device.

    ws = [WorkloadSpec("lublin", n_jobs=1000, n_nodes=128, seed=s, load=0.7)
          for s in range(16)]
    res = run_batched(grid(ws, ["GreedyP */OPT=MIN"]), device="cuda")

:func:`run_branches` forks one mid-run session snapshot under several
policies (what-if branches) and races them through the same lockstep
schedule on the device.

Only the ``baseline`` scenario (the unperturbed cell) is ported; the
scenario transforms, the record cache, the process pool and supervision
are not (see ROADMAP.md).
"""
from __future__ import annotations

import math
import threading
import time
from dataclasses import dataclass, field, replace
from typing import Any, Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np

from ..core.alloc_torch import LockstepDispatcher, TorchBatchedAllocator
from ..core.bound import max_stretch_lower_bound
from ..core.policies import parse_policy
from ..workloads.registry import WorkloadSpec, make_trace_ir
from .engine import Engine, SimParams

__all__ = ["Cell", "SweepResult", "grid", "run_batched", "run_branches"]


@dataclass(frozen=True)
class Cell:
    """One simulation point of a sweep grid."""

    workload: WorkloadSpec
    policy: str
    scenario: str = "baseline"
    params: Optional[SimParams] = None   # template; n_nodes comes from workload

    @property
    def name(self) -> str:
        return f"{self.workload.name} × {self.policy} × {self.scenario}"


def grid(
    workloads: Iterable[WorkloadSpec],
    policies: Iterable[str],
    scenarios: Iterable[str] = ("baseline",),
    params: Optional[SimParams] = None,
) -> List[Cell]:
    """Cross product of workloads × policies × scenarios."""
    return [
        Cell(w, p, sc, params)
        for w in workloads
        for p in policies
        for sc in scenarios
    ]


@dataclass
class SweepResult:
    records: List[Dict[str, Any]]
    wall_s: float
    #: the allocator's counters (dispatches, rounds, host syncs, shapes)
    alloc_stats: Dict[str, Any] = field(default_factory=dict)

    @property
    def n_cells(self) -> int:
        return len(self.records)

    @property
    def cells_per_sec(self) -> float:
        return self.n_cells / max(self.wall_s, 1e-9)


# --------------------------------------------------------------------------- #
# one cell                                                                     #
# --------------------------------------------------------------------------- #
def _materialize(workload: WorkloadSpec, scenario: str, compute_bound: bool):
    """Cell inputs: the workload trace (memoized by the registry), its
    cluster script, the optional Theorem-1 bound and the trace's content
    fingerprint."""
    if scenario != "baseline":
        raise NotImplementedError(
            f"scenario {scenario!r} is not ported yet (only 'baseline'); "
            f"see ROADMAP.md")
    trace = make_trace_ir(workload)
    bound = (max_stretch_lower_bound(trace.to_specs(), workload.n_nodes)
             if compute_bound else None)
    return trace, [], bound, trace.fingerprint


def _run_cell(task: Tuple[int, Cell, bool],
              alloc_backend: Optional[object] = None) -> Dict[str, Any]:
    idx, cell, compute_bound = task
    trace, events, bound, fingerprint = _materialize(
        cell.workload, cell.scenario, compute_bound)
    base = cell.params or SimParams()
    params = replace(base, n_nodes=cell.workload.n_nodes)
    t0 = time.perf_counter()
    engine = Engine(trace, cell.policy, params, cluster_events=events,
                    alloc_backend=alloc_backend)
    # batch baselines drop ClusterEvents (they don't model failures) — flag
    # the record so failure-scenario cells aren't read as simulated for them
    applied = engine.policy.handles_cluster_events or not events
    r = engine.run()
    wall = time.perf_counter() - t0
    rec: Dict[str, Any] = {
        "cell": idx,
        "workload": cell.workload.name,
        **cell.workload.to_dict(),
        "trace_fingerprint": fingerprint,
        "policy": cell.policy,
        "scenario": cell.scenario,
        "scenario_applied": applied,
        "period": params.period,
        "max_stretch": r.max_stretch,
        "mean_stretch": r.mean_stretch,
        "makespan": r.makespan,
        "underutilization": r.underutilization,
        "n_pmtn": r.n_pmtn,
        "n_mig": r.n_mig,
        "pmtn_per_job": r.pmtn_per_job,
        "mig_per_job": r.mig_per_job,
        "pmtn_per_hour": r.pmtn_per_hour,
        "mig_per_hour": r.mig_per_hour,
        "bytes_moved_gb": r.bytes_moved_gb,
        "bandwidth_gbps": r.bandwidth_gbps,
        "events": r.events,
        "hit_max_events": r.hit_max_events,
        "wall_s": wall,
        "n_events": r.n_events,
        "sim_wall_s": r.sim_wall_s,
        "final_time": r.final_time,
    }
    if bound is not None:
        rec["bound"] = bound
        rec["degradation"] = r.max_stretch / bound if bound > 0 else np.inf
    return rec


# --------------------------------------------------------------------------- #
# the batched driver                                                           #
# --------------------------------------------------------------------------- #
def _race_in_lockstep(n: int, allocator: TorchBatchedAllocator, run_lane
                      ) -> Tuple[List[Any], List[Optional[BaseException]]]:
    """Run ``run_lane(i, lane)`` for every ``i < n``, each in its own
    thread with lane ``i`` of one :class:`LockstepDispatcher` over
    ``allocator`` as its allocation backend, while this thread serves the
    device rounds.  Returns each lane's result and exception (``None``
    where there was none); a lane that raises leaves the barrier."""
    dispatcher = LockstepDispatcher(n, allocator)
    results: List[Any] = [None] * n
    errors: List[Optional[BaseException]] = [None] * n

    def _lane_main(i: int) -> None:
        try:
            results[i] = run_lane(i, dispatcher.lane(i))
        except BaseException as exc:  # noqa: BLE001 — returned to the caller
            errors[i] = exc
        finally:
            dispatcher.finish_lane(i)

    threads = [threading.Thread(target=_lane_main, args=(i,), daemon=True)
               for i in range(n)]
    for t in threads:
        t.start()
    try:
        dispatcher.serve()              # the device loop (this thread)
    finally:
        for t in threads:
            t.join()
    return results, errors


def run_batched(
    cells: Sequence[Cell],
    compute_bound: bool = False,
    device="cuda",
) -> SweepResult:
    """Evaluate every cell through the batched torch allocation backend.

    One device, one lockstep schedule: each cell's engine runs in its own
    thread with a :class:`LockstepDispatcher` lane as its allocation
    backend; this thread collects every live lane's §4.6 request per
    scheduling round and answers the round with one padded dispatch
    (OPT=AVG floors on the device, LPs on the host).  Per-lane results are
    bit-equal to the numpy kernels, so every record's simulation outcome
    equals a host run of the same cell (records carry ``backend="torch"``
    and their own wall times).

    ``device`` is ``"cuda"`` unless the caller asks for ``"cpu"`` (the
    kernels' plain PyTorch versions); without CUDA the default raises.  A
    lane that raises re-raises here once the other lanes are released.
    """
    allocator = TorchBatchedAllocator(device=device)
    t0 = time.perf_counter()
    n = len(cells)
    if n == 0:
        return SweepResult(records=[], wall_s=time.perf_counter() - t0,
                           alloc_stats=allocator.stats)
    records, errors = _race_in_lockstep(
        n, allocator, lambda i, lane: _run_cell((i, cells[i], compute_bound),
                                                alloc_backend=lane))
    first = next((e for e in errors if e is not None), None)
    if first is not None:
        raise first
    for rec in records:
        rec["backend"] = "torch"
    return SweepResult(records=records, wall_s=time.perf_counter() - t0,
                       alloc_stats=allocator.stats)


# --------------------------------------------------------------------------- #
# what-if branching: policy comparison from an identical live state            #
# --------------------------------------------------------------------------- #
_NO_POOL = ("timeout_s/retries need the supervised process pool of run_grid, "
            "which is not ported yet; see ROADMAP.md")


@dataclass(frozen=True)
class _Branch:
    """One what-if branch task: a snapshot forked under one policy/period
    variant, optionally horizon-bounded and early-stopped."""

    snap: Any                       # SessionState
    policy: str
    same: bool                      # continue the snapshot's own policy
    period: Optional[float] = None
    horizon_s: Optional[float] = None
    early_stop: Optional[Dict[str, float]] = None
    branch_seed: Optional[int] = None


def _canonical_policy(policy: str) -> str:
    """Identity of a policy string: the canonical grammar spelling (so
    ``"greedy *"`` and ``"Greedy */OPT=MIN"`` are one policy) or the
    verbatim name for registered compositions."""
    try:
        return parse_policy(policy).name
    except ValueError:
        return policy


def _quarantine_record(idx: int, br: _Branch, error: str,
                       attempts: int) -> Dict[str, Any]:
    """A record standing in for a branch that could not be simulated: the
    branch's identity fields, ``quarantined=True``, no metrics."""
    return {
        "cell": idx,
        "branch": idx,
        "policy": br.policy,
        "period": br.period,
        "branch_policy": br.snap.policy,
        "branch_time": br.snap.time,
        "branch_fingerprint": br.snap.fingerprint,
        "horizon_s": br.horizon_s,
        "branch_seed": br.branch_seed,
        "quarantined": True,
        "error": error,
        "attempts": attempts,
    }


#: early-stop progress check cadence (events between partial-metric looks).
#: Fixed, never caller-partitioned: the check points — and therefore the
#: stopped-at state — are deterministic for a given branch.
_EARLY_STOP_CHUNK = 256


def _run_branch(idx: int, br: _Branch, alloc_backend: Optional[object] = None,
                device="cuda") -> Dict[str, Any]:
    from .session import SimSession

    t1 = time.perf_counter()
    # the backend goes *into* restore, so nothing of the branch can
    # allocate outside it (a lockstep lane, or the host numpy path)
    ses = SimSession.restore(br.snap, policy=None if br.same else br.policy,
                             device=device, alloc_backend=alloc_backend)
    period_changed = False
    if br.period is not None and br.period != ses.engine.params.period:
        ses.set_period(br.period)
        period_changed = True
    target = (math.inf if br.horizon_s is None
              else br.snap.time + float(br.horizon_s))
    stopped = False
    thresh = (br.early_stop or {}).get("max_stretch_above")
    if thresh is not None:
        # chunked stepping with deterministic look points: completed-job
        # max stretch is monotone in sim time, so crossing the threshold
        # is final — stop paying for a branch that already lost
        while True:
            n = ses.step(_EARLY_STOP_CHUNK, until=target)
            if ses.result(partial=True, light=True).max_stretch > thresh:
                stopped = True
                break
            if n < _EARLY_STOP_CHUNK:
                break
    elif math.isinf(target):
        ses.run_to_exhaustion()
    else:
        ses.step_until(target)
    r = ses.result()
    wall = time.perf_counter() - t1
    return {
        "cell": idx,
        "branch": idx,
        "policy": br.policy,
        "period": ses.engine.params.period,
        "branch_policy": br.snap.policy,
        "branch_time": br.snap.time,
        "branch_fingerprint": br.snap.fingerprint,
        "exact_continuation": (br.same and not period_changed
                               and br.branch_seed is None),
        "horizon_s": br.horizon_s,
        "branch_seed": br.branch_seed,
        "early_stopped": stopped,
        "partial": not ses.exhausted,
        "max_stretch": r.max_stretch,
        "mean_stretch": r.mean_stretch,
        "makespan": r.makespan,
        "underutilization": r.underutilization,
        "n_pmtn": r.n_pmtn,
        "n_mig": r.n_mig,
        "pmtn_per_job": r.pmtn_per_job,
        "mig_per_job": r.mig_per_job,
        "bytes_moved_gb": r.bytes_moved_gb,
        "bandwidth_gbps": r.bandwidth_gbps,
        "events": r.events,
        "n_events": r.n_events,
        "hit_max_events": r.hit_max_events,
        "final_time": r.final_time,
        "sim_wall_s": r.sim_wall_s,
        "wall_s": wall,
    }


def run_branches(
    snapshot,
    policies: Sequence[Any],
    *,
    horizon_s: Optional[float] = None,
    early_stop: Optional[Dict[str, float]] = None,
    branch_seed: Optional[int] = None,
    timeout_s: Optional[float] = None,
    retries: int = 0,
    quarantine: bool = False,
    backend: str = "torch",
    device="cuda",
) -> SweepResult:
    """Fork one mid-run session snapshot under several policy variants.

    ``snapshot`` is a :class:`repro_torch.sched.session.SessionState` (or a
    path / JSON dict of one, from either package).  Every variant resumes
    from the *identical* live cluster state — same running set, same
    queue, same virtual times, same pending arrivals.  The snapshot's own
    policy continues bit-identically (``exact_continuation``); other
    policies adopt the live state (see ``SimSession.restore``).

    ``policies`` entries are policy strings, or ``{"policy": ...,
    "period": ...}`` dicts to race period variants of one policy.

    * ``horizon_s`` — each branch runs only to ``snapshot.time +
      horizon_s`` and reports *partial* metrics (``partial=True`` on
      unfinished branches).
    * ``early_stop`` — ``{"max_stretch_above": x}`` stops a branch at a
      deterministic check point once its completed-job max stretch exceeds
      ``x``; the record carries ``early_stopped=True``.
    * ``branch_seed`` — recorded; it reseeds a chaos narrator, which is not
      ported yet, so it changes nothing here.
    * ``quarantine`` — a crashing branch becomes a quarantine record
      instead of propagating.
    * ``timeout_s``/``retries`` — need the process pool; not ported.

    ``backend="torch"`` (the default) races every branch through one
    lockstep schedule on ``device`` (``"cuda"`` unless the caller asks for
    ``"cpu"``): each branch restores on a lane of one
    :class:`LockstepDispatcher` over one :class:`TorchBatchedAllocator`,
    whose counters come back as ``alloc_stats``; records carry
    ``backend="torch"``.  ``backend="numpy"`` runs the branches one after
    another on the host numpy path (the reference's serial path).
    """
    from .session import HOST_NUMPY, SessionState

    if timeout_s is not None or retries > 0:
        raise NotImplementedError(_NO_POOL)
    if backend not in ("torch", "numpy"):
        raise ValueError(f"unknown branch backend {backend!r}; "
                         f"expected 'torch' or 'numpy'")
    allocator = (TorchBatchedAllocator(device=device)
                 if backend == "torch" else None)
    if isinstance(snapshot, str):
        snapshot = SessionState.load(snapshot)
    elif isinstance(snapshot, dict):
        snapshot = SessionState.from_json_dict(snapshot)
    origin = (_canonical_policy(snapshot.policy)
              if snapshot.policy is not None else None)
    branches: List[_Branch] = []
    for entry in policies:
        if isinstance(entry, dict):
            policy = entry["policy"]
            period = entry.get("period")
            period = None if period is None else float(period)
        else:
            policy, period = entry, None
        same = origin is not None and _canonical_policy(policy) == origin
        branches.append(_Branch(
            snap=snapshot, policy=policy, same=same, period=period,
            horizon_s=horizon_s, early_stop=early_stop,
            branch_seed=branch_seed))
    t0 = time.perf_counter()
    if allocator is not None:
        records = _run_branches_batched(branches, allocator, device,
                                        quarantine)
        stats = allocator.stats
    else:
        records, stats = [], {}
        for i, br in enumerate(branches):
            try:
                records.append(_run_branch(i, br, alloc_backend=HOST_NUMPY))
            except Exception as exc:  # noqa: BLE001 — quarantined below
                if not quarantine:
                    raise
                records.append(_quarantine_record(
                    i, br, f"{type(exc).__name__}: {exc}", attempts=1))
    records.sort(key=lambda r: r["cell"])
    return SweepResult(records=records, wall_s=time.perf_counter() - t0,
                       alloc_stats=stats)


def _run_branches_batched(branches: Sequence[_Branch],
                          allocator: TorchBatchedAllocator, device,
                          quarantine: bool) -> List[Dict[str, Any]]:
    """Race every branch through one lockstep schedule on the device (the
    lanes of :func:`run_batched`; each lane hands its dispatcher lane into
    the branch's restore)."""
    if not branches:
        return []
    records, errors = _race_in_lockstep(
        len(branches), allocator,
        lambda i, lane: _run_branch(i, branches[i], alloc_backend=lane,
                                    device=device))
    first = next((e for e in errors if e is not None), None)
    if first is not None and not quarantine:
        raise first
    out: List[Dict[str, Any]] = []
    for i, (rec, err) in enumerate(zip(records, errors)):
        if rec is None:
            msg = (f"{type(err).__name__}: {err}" if err is not None
                   else "lane produced no record")
            out.append(_quarantine_record(i, branches[i], msg, attempts=1))
        else:
            rec["backend"] = "torch"
            out.append(rec)
    return out
