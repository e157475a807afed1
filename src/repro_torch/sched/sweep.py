"""Scenario sweeps: evaluate a grid of simulation cells on one device or a
pool of host processes.

A :class:`Cell` is one (workload × policy × scenario) point — the workload
a declarative :class:`repro_torch.workloads.registry.WorkloadSpec`, the
scenario a ``+`` chain of names from :mod:`repro_torch.sched.scenarios`.
:func:`run_grid` evaluates a grid two ways, with equal records in every
outcome field:

* ``backend="torch"`` (the default) — :func:`run_batched`: every cell's
  engine runs in its own thread with a lane of one
  :class:`~repro_torch.core.alloc_torch.LockstepDispatcher` as its
  allocation backend; the driver thread collects every live lane's §4.6
  request per scheduling round, pads them into one dense batch, and answers
  the round with one lockstep water-filling on ``device``;
* ``backend="numpy"`` — the host path: serial in-process, a chunked process
  pool, or, with ``timeout_s``/``retries``, a supervised pool that gives
  every cell a wall-clock budget and bounded retries on fresh workers and
  turns cells that exhaust them into quarantine records.  Pool workers run
  host cells only; they never touch the card.

    ws = [WorkloadSpec("lublin", n_jobs=1000, n_nodes=128, seed=s, load=0.7)
          for s in range(16)]
    res = run_grid(grid(ws, ["GreedyP */OPT=MIN"], ["baseline",
                                                    "rack_failure"]),
                   compute_bound=True)
    res.save_json("experiments/results/sweep.json")

:class:`RecordCache` memoizes records (optionally in one JSON file, the
``repro.sweep-cache/v1`` format the JAX package writes too) and simulates
only the misses.  :func:`run_branches` forks one mid-run session snapshot
under several policies (what-if branches) and races them through the same
lockstep schedule on the device, or on the host.
"""
from __future__ import annotations

import dataclasses
import json
import math
import multiprocessing as mp
import os
import sys
import threading
import time
from dataclasses import dataclass, field, replace
from typing import Any, Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..core.alloc_torch import LockstepDispatcher, TorchBatchedAllocator
from ..core.bound import max_stretch_lower_bound
from ..core.ioutil import atomic_write_json
from ..core.policies import parse_policy
from ..workloads.registry import WorkloadSpec, make_trace_ir
from .engine import Engine, SimParams
from .scenarios import apply_scenario_trace, parse_scenario_chain

__all__ = ["Cell", "SweepResult", "RecordCache", "grid", "run_grid",
           "run_batched", "run_branches", "record_matches"]

_BACKENDS = ("torch", "numpy")


def record_matches(record: Dict[str, Any], kv: Dict[str, Any]) -> bool:
    """Shared record predicate: every kv pair equals the record's value."""
    return all(record.get(k) == v for k, v in kv.items())


def _check_backend(backend: str, what: str) -> None:
    if backend not in _BACKENDS:
        raise ValueError(f"unknown {what} backend {backend!r}; expected "
                         f"'torch' (lockstep on a device) or 'numpy' (host)")


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
    n_workers: int = 1
    #: the device allocator's counters (dispatches, rounds, host syncs,
    #: shapes); empty on the host path
    alloc_stats: Dict[str, Any] = field(default_factory=dict)

    @property
    def n_cells(self) -> int:
        return len(self.records)

    @property
    def cells_per_sec(self) -> float:
        return self.n_cells / max(self.wall_s, 1e-9)

    @property
    def quarantined(self) -> List[Dict[str, Any]]:
        """Cells that could not be simulated under a supervised run: the
        sweep completed without them, and each carries ``error``/``attempts``
        instead of metrics."""
        return [r for r in self.records if r.get("quarantined")]

    @property
    def n_quarantined(self) -> int:
        return len(self.quarantined)

    def filter(self, **kv) -> List[Dict[str, Any]]:
        return [r for r in self.records if record_matches(r, kv)]

    def values(self, key: str, **kv) -> np.ndarray:
        return np.array([r[key] for r in self.filter(**kv)])

    def summary(self, by: str = "policy",
                keys: Sequence[str] = ("mean_stretch", "max_stretch")) -> Dict:
        """Per-group mean/max aggregates of the chosen metric keys."""
        groups: Dict[str, List[Dict[str, Any]]] = {}
        for r in self.records:
            if r.get("quarantined"):
                continue            # no metrics to aggregate
            groups.setdefault(str(r[by]), []).append(r)
        out = {}
        for g, rs in sorted(groups.items()):
            out[g] = {"n_cells": len(rs)}
            for k in keys:
                vals = np.array([r[k] for r in rs], dtype=float)
                out[g][f"mean_{k}"] = float(vals.mean())
                out[g][f"max_{k}"] = float(vals.max())
        return out

    def to_dict(self) -> Dict[str, Any]:
        return {
            "schema": "repro.sweep/v1",
            "n_cells": self.n_cells,
            "n_quarantined": self.n_quarantined,
            "wall_s": self.wall_s,
            "cells_per_sec": self.cells_per_sec,
            "n_workers": self.n_workers,
            "records": self.records,
        }

    def save_json(self, path: str) -> str:
        """Write the artifact atomically (tmp file + rename), creating
        parent directories — a reader never observes a torn file."""
        return _atomic_write_json(path, self.to_dict())


def _atomic_write_json(path: str, payload: Any) -> str:
    # unique-temp-name atomic replace: concurrent writers sharing one
    # cache file never collide on a temp path or observe a torn file
    return atomic_write_json(path, payload, indent=1)


# --------------------------------------------------------------------------- #
# one cell                                                                     #
# --------------------------------------------------------------------------- #
# per-process memo:
# (workload, scenario, compute_bound) -> (trace, events, bound, fingerprint)
_CELL_CACHE: Dict[Tuple[WorkloadSpec, str, bool], Tuple] = {}
# run_batched's lane threads materialize concurrently: one at a time, so a
# (workload, scenario) bound is computed once, not once per lane
_CELL_LOCK = threading.Lock()


def _materialize(workload: WorkloadSpec, scenario: str, compute_bound: bool):
    """Columnar cell inputs: the workload trace (memoized per process by the
    registry), the scenario chain applied as vectorized Trace transforms
    (new columns; the memoized trace is never written), the optional
    Theorem-1 bound, and the workload trace's content fingerprint for
    cache identity."""
    key = (workload, scenario, compute_bound)
    with _CELL_LOCK:
        hit = _CELL_CACHE.get(key)
        if hit is not None:
            return hit
        base = make_trace_ir(workload)
        trace, events = apply_scenario_trace(scenario, base,
                                             workload.n_nodes,
                                             seed=workload.seed)
        bound = (max_stretch_lower_bound(trace.to_specs(), workload.n_nodes)
                 if compute_bound else None)
        out = (trace, events, bound, base.fingerprint)
        if len(_CELL_CACHE) > 32:       # sweeps iterate policies per workload
            _CELL_CACHE.clear()
        _CELL_CACHE[key] = out
        return out


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
# supervised execution: timeouts, bounded retries, quarantine                  #
# --------------------------------------------------------------------------- #
def _quarantine_record(idx: int, cell: Any, error: str,
                       attempts: int) -> Dict[str, Any]:
    """A record standing in for a cell (or what-if branch) that could not
    be simulated: same identity fields as a real record,
    ``quarantined=True``, no metrics."""
    if isinstance(cell, _Branch):
        return {
            "cell": idx,
            "branch": idx,
            "policy": cell.policy,
            "period": cell.period,
            "branch_policy": cell.snap.policy,
            "branch_time": cell.snap.time,
            "branch_fingerprint": cell.snap.fingerprint,
            "horizon_s": cell.horizon_s,
            "branch_seed": cell.branch_seed,
            "quarantined": True,
            "error": error,
            "attempts": attempts,
        }
    return {
        "cell": idx,
        "workload": cell.workload.name,
        **cell.workload.to_dict(),
        "policy": cell.policy,
        "scenario": cell.scenario,
        "quarantined": True,
        "error": error,
        "attempts": attempts,
    }


def _supervised_worker(conn) -> None:
    """Worker loop for the supervised driver: receive one ``(idx, cell,
    compute_bound)`` task at a time, answer with ``("ok", record)`` or
    ``("err", message)``.  Exits when the driver sends ``None`` or drops
    the pipe."""
    try:
        while True:
            task = conn.recv()
            if task is None:
                break
            try:
                rec = _run_task(task)
            except BaseException as exc:  # noqa: BLE001 — reported; driver decides
                conn.send(("err", f"{type(exc).__name__}: {exc}"))
            else:
                conn.send(("ok", rec))
    except (EOFError, OSError, KeyboardInterrupt):
        pass
    finally:
        try:
            conn.close()
        except OSError:
            pass


class _Worker:
    """One supervised worker process plus its duplex pipe and current task."""

    __slots__ = ("proc", "conn", "task", "t0")

    def __init__(self, ctx):
        parent, child = ctx.Pipe(duplex=True)
        self.proc = ctx.Process(target=_supervised_worker, args=(child,),
                                daemon=True)
        self.proc.start()
        child.close()
        self.conn = parent
        self.task: Optional[Tuple] = None
        self.t0 = 0.0

    def kill(self) -> None:
        try:
            self.conn.close()
        except OSError:
            pass
        if self.proc.is_alive():
            self.proc.terminate()
        self.proc.join(timeout=2.0)
        if self.proc.is_alive():
            self.proc.kill()
            self.proc.join(timeout=2.0)

    def shutdown(self) -> None:
        try:
            self.conn.send(None)
        except (OSError, BrokenPipeError):
            pass
        self.kill()


def _run_supervised(
    tasks: Sequence[Tuple],
    n_workers: int,
    timeout_s: Optional[float],
    retries: int,
) -> List[Dict[str, Any]]:
    """Supervising driver: every task gets a wall-clock budget and a bounded
    number of retries on fresh worker processes; tasks that exhaust their
    budget become quarantine records instead of taking the sweep down.  A
    hung cell costs its own timeout, never the grid's."""
    ctx = _pool_context()
    n_workers = max(1, min(n_workers, len(tasks)))
    pending: List[Tuple] = list(reversed(tasks))    # pop() == grid order
    attempts: Dict[int, int] = {}
    records: Dict[int, Dict[str, Any]] = {}

    def retire(w: _Worker, error: str) -> None:
        idx, cell, _ = w.task
        tries = attempts[idx] = attempts.get(idx, 0) + 1
        if tries > retries:
            records[idx] = _quarantine_record(idx, cell, error, tries)
        else:
            pending.append(w.task)      # retried on a fresh worker
        w.task = None

    workers = [_Worker(ctx) for _ in range(n_workers)]
    try:
        while len(records) < len(tasks):
            for w in workers:
                if w.task is None and pending:
                    w.task = pending.pop()
                    w.t0 = time.perf_counter()
                    w.conn.send(w.task)
            busy = [w for w in workers if w.task is not None]
            if not busy:
                break
            wait_s = 0.25
            if timeout_s is not None:
                now = time.perf_counter()
                slack = min(timeout_s - (now - w.t0) for w in busy)
                wait_s = min(wait_s, max(slack, 0.01))
            ready = set(mp.connection.wait([w.conn for w in busy],
                                           timeout=wait_s))
            now = time.perf_counter()
            for i, w in enumerate(workers):
                if w.task is None:
                    continue
                if w.conn in ready:
                    try:
                        kind, payload = w.conn.recv()
                    except (EOFError, OSError):
                        # the process died mid-cell (segfault, OOM kill)
                        kind, payload = "err", "worker process died"
                    if kind == "ok":
                        records[w.task[0]] = payload
                        w.task = None
                        continue
                    retire(w, payload)
                elif timeout_s is not None and now - w.t0 > timeout_s:
                    retire(w, f"timeout after {timeout_s:g}s")
                else:
                    continue
                # failed attempt: the old process may be wedged or tainted —
                # replace it so the retry runs on a fresh worker
                w.kill()
                workers[i] = _Worker(ctx)
    finally:
        for w in workers:
            w.shutdown()
    return [records[i] for i in sorted(records)]


def _pool_context() -> mp.context.BaseContext:
    """Pick a start method: fork is fastest, but a process whose CUDA
    context exists must not be forked, so once the card is initialized
    prefer forkserver/spawn.  Those methods re-import ``__main__`` in the
    worker, which breaks for stdin/REPL parents — in that corner fall back
    to fork anyway (the workers run host cells only and never touch the
    card)."""
    methods = mp.get_all_start_methods()
    if "fork" in methods and not torch.cuda.is_initialized():
        return mp.get_context("fork")
    main = sys.modules.get("__main__")
    main_file = getattr(main, "__file__", None)
    main_importable = (
        main_file is None
        or os.path.exists(main_file)
        or getattr(main, "__spec__", None) is not None
    )
    if main_importable:
        for method in ("forkserver", "spawn"):
            if method in methods:
                return mp.get_context(method)
    return mp.get_context("fork" if "fork" in methods else "spawn")


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
            results[i] = dispatcher.run(i, lambda lane: run_lane(i, lane))
        except BaseException as exc:  # noqa: BLE001 — returned to the caller
            errors[i] = exc

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


def _lockstep_records(tasks: Sequence[Tuple], allocator: TorchBatchedAllocator,
                      quarantine: bool) -> List[Dict[str, Any]]:
    """Race ``tasks`` (grid cells or what-if branches) through one lockstep
    schedule on the allocator's device.  A lane that raises re-raises here
    once the other lanes are released, unless ``quarantine`` turns it into
    a quarantine record."""
    if not tasks:
        return []
    records, errors = _race_in_lockstep(
        len(tasks), allocator,
        lambda i, lane: _run_task(tasks[i], alloc_backend=lane))
    first = next((e for e in errors if e is not None), None)
    if first is not None and not quarantine:
        raise first
    out: List[Dict[str, Any]] = []
    for i, (rec, err) in enumerate(zip(records, errors)):
        if rec is None:
            msg = (f"{type(err).__name__}: {err}" if err is not None
                   else "lane produced no record")
            out.append(_quarantine_record(i, tasks[i][1], msg, attempts=1))
        else:
            rec["backend"] = "torch"
            out.append(rec)
    return out


def run_batched(
    cells: Sequence[Cell],
    compute_bound: bool = False,
    json_path: Optional[str] = None,
    quarantine: bool = False,
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
    lane that raises re-raises here once the other lanes are released; with
    ``quarantine=True`` it becomes a quarantine record instead.  Lanes are
    threads, so per-cell wall-clock timeouts are not enforceable here — use
    the host pool (``run_grid(backend="numpy")``) for that.
    """
    allocator = TorchBatchedAllocator(device=device)
    t0 = time.perf_counter()
    tasks = [(i, c, compute_bound) for i, c in enumerate(cells)]
    res = SweepResult(records=_lockstep_records(tasks, allocator, quarantine),
                      wall_s=time.perf_counter() - t0,
                      alloc_stats=allocator.stats)
    if json_path is not None:
        res.save_json(json_path)
    return res


def run_grid(
    cells: Sequence[Cell],
    n_workers: int = 1,
    chunksize: Optional[int] = None,
    compute_bound: bool = False,
    json_path: Optional[str] = None,
    backend: str = "torch",
    timeout_s: Optional[float] = None,
    retries: int = 0,
    device="cuda",
) -> SweepResult:
    """Evaluate every cell; records come back in grid order.

    ``backend="torch"`` (the default) routes the whole grid through
    :func:`run_batched` on ``device`` (``"cuda"`` unless the caller asks
    for ``"cpu"``): one lockstep schedule, ``n_workers``/``chunksize`` do
    not apply, and ``timeout_s``/``retries`` mean "complete the sweep" —
    a failed lane becomes a quarantine record (lanes are threads, so there
    is no per-cell wall-clock budget there).

    ``backend="numpy"`` is the host path: ``n_workers <= 1`` runs serially
    in-process; otherwise a process pool consumes the cell list in chunks
    of ``chunksize`` (default: ~4 chunks per worker so stragglers
    rebalance).  ``timeout_s``/``retries`` turn the driver into a
    supervisor: each cell gets a wall-clock budget (``timeout_s``, ``None``
    = unlimited) and up to ``retries`` re-runs on fresh worker processes;
    cells that exhaust their budget come back as quarantine records
    (``quarantined=True``, with ``error`` and ``attempts``) and the rest of
    the sweep completes.  Supervision always uses worker processes, even at
    ``n_workers=1``, so a hung cell can be terminated.

    Either way the records are equal in every outcome field.  With
    ``compute_bound`` each record also carries the Theorem-1 lower bound of
    its (scenario-transformed) trace and the achieved ``degradation``;
    ``json_path`` additionally writes the artifact.

    Once the card is initialized the pool starts its workers with
    forkserver/spawn (see ``_pool_context``), which re-imports ``__main__``
    — scripts calling this need the usual ``if __name__ == "__main__"``
    guard.
    """
    _check_backend(backend, "sweep")
    supervised = timeout_s is not None or retries > 0
    if backend == "torch":
        return run_batched(cells, compute_bound=compute_bound,
                           json_path=json_path, quarantine=supervised,
                           device=device)
    tasks = [(i, c, compute_bound) for i, c in enumerate(cells)]
    t0 = time.perf_counter()
    if supervised:
        records = _run_supervised(tasks, n_workers, timeout_s, retries)
        n_workers = max(1, min(n_workers, len(tasks))) if tasks else 1
    elif n_workers <= 1 or len(tasks) <= 1:
        records = [_run_cell(t) for t in tasks]
        n_workers = 1
    else:
        if chunksize is None:
            chunksize = max(1, len(tasks) // (4 * n_workers))
        with _pool_context().Pool(processes=n_workers) as pool:
            records = list(pool.imap_unordered(_run_cell, tasks,
                                               chunksize=chunksize))
    records.sort(key=lambda r: r["cell"])
    res = SweepResult(records=records, wall_s=time.perf_counter() - t0,
                      n_workers=n_workers)
    if json_path is not None:
        res.save_json(json_path)
    return res


# --------------------------------------------------------------------------- #
# what-if branching: policy comparison from an identical live state            #
# --------------------------------------------------------------------------- #
@dataclass(frozen=True)
class _Branch:
    """One what-if branch task: a snapshot forked under one policy/period
    variant, optionally horizon-bounded, early-stopped, and chaos-reseeded.
    Picklable (travels through the supervised worker pipes)."""

    snap: Any                       # SessionState
    policy: str
    same: bool                      # continue the snapshot's own policy
    period: Optional[float] = None
    horizon_s: Optional[float] = None
    early_stop: Optional[Dict[str, float]] = None
    branch_seed: Optional[int] = None


def _canonical_policy(policy: str) -> str:
    """Identity of a policy string: the canonical grammar spelling (so
    ``"greedy *"`` and ``"Greedy */OPT=MIN"`` are one policy, and share a
    cache slot) or the verbatim name for registered compositions."""
    try:
        return parse_policy(policy).name
    except ValueError:
        return policy


def _run_task(task: Tuple, alloc_backend: Optional[object] = None
              ) -> Dict[str, Any]:
    """Grid cells and what-if branches share the supervised driver and the
    lockstep lanes.  Without ``alloc_backend`` both run on the host numpy
    path (a pool worker never touches the card)."""
    if isinstance(task[1], _Branch):
        from .session import HOST_NUMPY
        return _run_branch(task, alloc_backend=alloc_backend or HOST_NUMPY)
    return _run_cell(task, alloc_backend=alloc_backend)


#: early-stop progress check cadence (events between partial-metric looks).
#: Fixed, never caller-partitioned: the check points — and therefore the
#: stopped-at state — are deterministic for a given branch.
_EARLY_STOP_CHUNK = 256


def _run_branch(task: Tuple[int, "_Branch", Any],
                alloc_backend: object) -> Dict[str, Any]:
    idx, br, _ = task
    from .session import SimSession

    t1 = time.perf_counter()
    # the backend goes *into* restore, so nothing of the branch can
    # allocate outside it (a lockstep lane, or the host numpy path)
    ses = SimSession.restore(br.snap, policy=None if br.same else br.policy,
                             alloc_backend=alloc_backend)
    ses._tuner = None           # branches race under a tuner, never run one
    period_changed = False
    if br.period is not None and br.period != ses.engine.params.period:
        ses.set_period(br.period)
        period_changed = True
    if br.branch_seed is not None and ses.narrator is not None:
        ses.narrator.reseed(br.branch_seed)
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
    json_path: Optional[str] = None,
    *,
    horizon_s: Optional[float] = None,
    early_stop: Optional[Dict[str, float]] = None,
    branch_seed: Optional[int] = None,
    timeout_s: Optional[float] = None,
    retries: int = 0,
    quarantine: bool = False,
    backend: str = "torch",
    n_workers: int = 1,
    device="cuda",
) -> SweepResult:
    """Fork one mid-run session snapshot under several policy variants.

    ``snapshot`` is a :class:`repro_torch.sched.session.SessionState` (or a
    path / JSON dict of one, from either package).  Every variant resumes
    from the *identical* live cluster state — same running set, same
    queue, same virtual times, same pending arrivals.  The snapshot's own
    policy continues bit-identically (``exact_continuation``); other
    policies adopt the live state (see ``SimSession.restore``).  An
    attached autotuner never follows into a branch.

    ``policies`` entries are policy strings, or ``{"policy": ...,
    "period": ...}`` dicts to race period variants of one policy.

    * ``horizon_s`` — each branch runs only to ``snapshot.time +
      horizon_s`` and reports *partial* metrics (``partial=True`` on
      unfinished branches).
    * ``early_stop`` — ``{"max_stretch_above": x}`` stops a branch at a
      deterministic check point once its completed-job max stretch exceeds
      ``x``; the record carries ``early_stopped=True``.
    * ``branch_seed`` — reseed every branch's chaos narrator with this
      common seed: branches race under *common random numbers* while being
      decorrelated from the live session's actual future.
    * ``quarantine`` — a crashing branch becomes a quarantine record
      instead of propagating.
    * ``timeout_s``/``retries`` — on the host path, the supervised driver
      of :func:`run_grid` (``n_workers`` processes): each branch gets a
      wall-clock budget and bounded retries on fresh workers; exhausted
      branches come back as quarantine records.  On the device path they
      quarantine failed lanes.  Wall-clock supervision is inherently
      nondeterministic — leave it off where bit-identical replay matters.

    ``backend="torch"`` (the default) races every branch through one
    lockstep schedule on ``device`` (``"cuda"`` unless the caller asks for
    ``"cpu"``): each branch restores on a lane of one
    :class:`LockstepDispatcher` over one :class:`TorchBatchedAllocator`,
    whose counters come back as ``alloc_stats``; records carry
    ``backend="torch"``.  ``backend="numpy"`` runs the branches on the
    host numpy path: one after another, or supervised in worker processes.
    """
    from .session import SessionState

    _check_backend(backend, "branch")
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
    tasks = [(i, br, None) for i, br in enumerate(branches)]
    supervised = timeout_s is not None or retries > 0
    t0 = time.perf_counter()
    stats: Dict[str, Any] = {}
    if allocator is not None:
        records = _lockstep_records(tasks, allocator,
                                    quarantine or supervised)
        stats = allocator.stats
    elif supervised:
        records = _run_supervised(tasks, n_workers, timeout_s, retries)
    else:
        records = []
        for t in tasks:
            try:
                records.append(_run_task(t))
            except Exception as exc:  # noqa: BLE001 — quarantined below
                if not quarantine:
                    raise
                records.append(_quarantine_record(
                    t[0], t[1], f"{type(exc).__name__}: {exc}", attempts=1))
    records.sort(key=lambda r: r["cell"])
    res = SweepResult(records=records, wall_s=time.perf_counter() - t0,
                      alloc_stats=stats)
    if json_path is not None:
        res.save_json(json_path)
    return res


# --------------------------------------------------------------------------- #
# resumable record cache                                                       #
# --------------------------------------------------------------------------- #
CACHE_SCHEMA = "repro.sweep-cache/v1"


def _canonical_scenario(scenario: str) -> str:
    """Cache identity of a scenario chain: whitespace-insensitive link
    spelling (``"a + b"`` and ``"a+b"`` share a record); unknown names pass
    through verbatim so stale cached records never crash a load."""
    try:
        return "+".join(parse_scenario_chain(scenario))
    except KeyError:
        return scenario


def _params_key(params: SimParams) -> Dict[str, Any]:
    """The SimParams fields that are part of a cell's cache identity:
    everything except ``n_nodes`` (always taken from the workload) and
    ``period`` (already a key dimension of its own)."""
    d = dataclasses.asdict(params)
    d.pop("n_nodes")
    d.pop("period")
    return d


def _params_tuple(params: Dict[str, Any]) -> Tuple:
    return tuple(sorted(params.items()))


def _record_key(rec: Dict[str, Any]) -> Tuple:
    # no backend in the key: the torch and numpy paths give equal records
    return (rec["kind"], rec["n_jobs"], rec["n_nodes"], rec["seed"],
            rec["load"], _params_tuple(rec["params"]),
            rec["trace_fingerprint"],
            _canonical_policy(rec["policy"]),
            _canonical_scenario(rec["scenario"]),
            float(rec["period"]),
            tuple(sorted(rec["sim_params"].items())))


class RecordCache:
    """Memoized sweep records, optionally persisted to one JSON file.

    Each (workload × policy × period × scenario × SimParams template) cell
    is simulated at most once per cache; :meth:`sweep` fans only the misses
    through :func:`run_grid` and — when constructed with a ``path`` —
    writes the cache back atomically after every miss batch, so an
    interrupted run resumes where it stopped and parallel runs never
    observe torn artifacts.  Policy strings are canonicalized for cache
    identity; keys also carry the workload trace's content fingerprint, so
    records cached for a different trace are re-simulated instead of
    silently reused.  The file format is the JAX package's: a cache written
    by either package reads in the other as hits.
    """

    def __init__(self, path: Optional[str] = None):
        self.path = path
        self._records: Dict[Tuple, Dict[str, Any]] = {}
        if path is None or not os.path.exists(path):
            return
        try:
            with open(path) as f:
                payload = json.load(f)
        except (json.JSONDecodeError, UnicodeDecodeError, OSError) as exc:
            # a truncated or corrupted cache is a cache *miss*, not a
            # crash: warn once, start empty, and let the next checkpoint
            # rewrite the file atomically
            print(f"warning: record cache {path} is unreadable "
                  f"({type(exc).__name__}: {exc}); starting empty and "
                  f"re-simulating", file=sys.stderr)
            return
        schema = payload.get("schema") if isinstance(payload, dict) else None
        if schema != CACHE_SCHEMA:
            # valid JSON that is *not* ours: refusing protects the foreign
            # file from being overwritten by save()
            raise ValueError(
                f"{path} is not a {CACHE_SCHEMA} record cache (schema: "
                f"{schema!r}); refusing to overwrite it — pass a fresh "
                f"path (sweep artifacts from json_path are a different "
                f"format)")
        required = {"sim_params", "params", "trace_fingerprint",
                    "n_events", "sim_wall_s", "final_time"}
        dropped = 0
        for rec in payload.get("records", []):
            if not isinstance(rec, dict) or not required <= set(rec):
                continue        # record from an older schema: re-simulate
                # it rather than mixing schemas
            try:
                self._records[_record_key(rec)] = rec
            except (KeyError, TypeError, ValueError, AttributeError):
                dropped += 1    # individually malformed record -> miss
        if dropped:
            print(f"warning: record cache {path}: dropped {dropped} "
                  f"malformed record(s); they will be re-simulated",
                  file=sys.stderr)

    def __len__(self) -> int:
        return len(self._records)

    @property
    def records(self) -> List[Dict[str, Any]]:
        return list(self._records.values())

    def save(self) -> Optional[str]:
        if self.path is None:
            return None
        return _atomic_write_json(self.path, {
            "schema": CACHE_SCHEMA,
            "n_records": len(self._records),
            "records": self.records,
        })

    def sweep(
        self,
        workloads: Iterable[WorkloadSpec],
        policies: Iterable[str],
        periods: Iterable[float] = (600.0,),
        scenarios: Iterable[str] = ("baseline",),
        params: Optional[SimParams] = None,
        n_workers: int = 1,
        chunksize: Optional[int] = None,
        compute_bound: bool = True,
        timeout_s: Optional[float] = None,
        retries: int = 0,
        backend: str = "torch",
        device="cuda",
    ) -> List[Dict[str, Any]]:
        """Records for the full cross product, simulating only cache misses
        (through :func:`run_grid` with ``backend``/``device``: on the card
        unless the caller asks for ``backend="numpy"``).

        A cached record without a Theorem-1 ``bound`` counts as a miss when
        ``compute_bound`` is requested (it is re-simulated with the bound).

        ``timeout_s``/``retries`` supervise the misses (see
        :func:`run_grid`): cells exhausting their budget come back as
        quarantine records.  Quarantined records are returned but **never
        cached** — a later sweep over the same grid retries them.
        """
        _check_backend(backend, "sweep")
        base = params or SimParams()
        pkey_dict = _params_key(base)
        pkey = tuple(sorted(pkey_dict.items()))
        # materialize up front: one-pass iterables would silently empty the
        # inner loops after the first period otherwise
        workloads, policies = list(workloads), list(policies)
        periods, scenarios = list(periods), list(scenarios)
        want: List[Tuple[WorkloadSpec, str, float, str]] = [
            (w, p, float(per), sc)
            for per in periods for w in workloads
            for p in policies for sc in scenarios
        ]

        for sc in scenarios:
            parse_scenario_chain(sc)    # fail fast, driver-side
        # one fingerprint per distinct workload, materialized driver-side
        # exactly once
        fps = {w: make_trace_ir(w).fingerprint for w in set(workloads)}

        def key_of(w: WorkloadSpec, p: str, per: float, sc: str) -> Tuple:
            return (w.kind, w.n_jobs, w.n_nodes, w.seed, w.load, w.params,
                    fps[w], _canonical_policy(p), _canonical_scenario(sc),
                    per, pkey)

        def hit(k: Tuple) -> bool:
            rec = self._records.get(k)
            return rec is not None and (not compute_bound or "bound" in rec)

        # dedup misses by *canonical* key — equivalent spellings (and
        # verbatim duplicates) of one cell must be simulated once
        missing: List[Tuple[WorkloadSpec, str, float, str]] = []
        missing_keys: List[Tuple] = []
        seen: set = set()
        for t in want:
            k = key_of(*t)
            if k in seen or hit(k):
                continue
            seen.add(k)
            missing.append(t)
            missing_keys.append(k)
        # with a disk path, checkpoint the cache every few miss chunks so an
        # interrupted sweep resumes mid-batch, not only between sweep() calls
        step = len(missing) if self.path is None else max(4 * n_workers, 8)
        quarantined: Dict[Tuple, Dict[str, Any]] = {}
        for lo in range(0, len(missing), max(step, 1)):
            batch = missing[lo:lo + step]
            batch_keys = missing_keys[lo:lo + step]
            cells = [Cell(w, p, sc, params=replace(base, period=per))
                     for (w, p, per, sc) in batch]
            res = run_grid(cells, n_workers=n_workers, chunksize=chunksize,
                           compute_bound=compute_bound,
                           timeout_s=timeout_s, retries=retries,
                           backend=backend, device=device)
            for k, rec in zip(batch_keys, res.records):
                if rec.get("quarantined"):
                    quarantined[k] = rec   # returned, never persisted —
                    continue               # the next sweep retries the cell
                rec["sim_params"] = dict(pkey_dict)   # disk-key round-trip
                self._records[k] = rec
            self.save()
        # returned records mirror run_grid semantics: "policy"/"scenario"
        # are the spellings the caller asked for and "cell" is the
        # want-order index
        out: List[Dict[str, Any]] = []
        for i, t in enumerate(want):
            k = key_of(*t)
            src = self._records.get(k)
            if src is None:
                src = quarantined[k]
            rec = dict(src)
            rec["policy"] = t[1]
            rec["scenario"] = t[3]
            rec["cell"] = i
            out.append(rec)
        return out
