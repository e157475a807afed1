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

Only the ``baseline`` scenario (the unperturbed cell) is ported; the
scenario transforms, the record cache, the process pool, supervision and
what-if branches are not (see ROADMAP.md).
"""
from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field, replace
from typing import Any, Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np

from ..core.alloc_torch import LockstepDispatcher, TorchBatchedAllocator
from ..core.bound import max_stretch_lower_bound
from ..workloads.registry import WorkloadSpec, make_trace_ir
from .engine import Engine, SimParams

__all__ = ["Cell", "SweepResult", "grid", "run_batched"]


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
    dispatcher = LockstepDispatcher(n, allocator)
    records: List[Optional[Dict[str, Any]]] = [None] * n
    errors: List[Optional[BaseException]] = [None] * n

    def _lane_main(i: int) -> None:
        try:
            records[i] = _run_cell((i, cells[i], compute_bound),
                                   alloc_backend=dispatcher.lane(i))
        except BaseException as exc:  # noqa: BLE001 — re-raised by driver
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
    first = next((e for e in errors if e is not None), None)
    if first is not None:
        raise first
    for rec in records:
        rec["backend"] = "torch"
    return SweepResult(records=records, wall_s=time.perf_counter() - t0,
                       alloc_stats=allocator.stats)
