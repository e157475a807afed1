"""The port's scheduling path against the JAX package's, end to end.

The same Lublin spec must give the same trace fingerprint in both
packages; the port's ``Engine`` must give a ``SimResult`` equal to the
reference's on every slice policy, on its numpy path and with the torch
allocator on the CPU; ``run_batched(device="cpu")`` must reproduce the
reference ``run_grid`` records, on grids that mix the MCB8 family
(``/per``, ``/stretch-per``, ``MCB8 *``) with greedy and batch lanes on
Lublin and HPC2N traces; and a bad lane must raise without deadlock.
"""
import dataclasses
import threading

import numpy as np
import pytest

from repro.sched.engine import Engine as RefEngine, SimParams as RefParams
from repro.sched.sweep import grid as ref_grid, run_grid as ref_run_grid
from repro.workloads.registry import (WorkloadSpec as RefWorkload,
                                      make_trace_ir as ref_trace)

from repro_torch import api
from repro_torch.core.alloc_torch import TorchAllocBackend
from repro_torch.sched.engine import Engine, SimParams
from repro_torch.sched.sweep import Cell, grid, run_batched
from repro_torch.workloads.registry import WorkloadSpec, make_trace_ir
from repro_torch.workloads.trace import COLUMNS, Trace

SLICE_POLICIES = ["GreedyP */OPT=MIN", "GreedyPM */OPT=MIN",
                  "Greedy */OPT=AVG", "EASY+OPT=MIN", "FCFS", "EASY"]

_OUTCOME_KEYS = (
    "max_stretch", "mean_stretch", "makespan", "underutilization",
    "n_pmtn", "n_mig", "pmtn_per_job", "mig_per_job", "pmtn_per_hour",
    "mig_per_hour", "bytes_moved_gb", "bandwidth_gbps", "events",
    "hit_max_events", "final_time", "trace_fingerprint", "n_events",
    "scenario_applied", "period", "workload", "kind", "n_jobs", "n_nodes",
    "seed", "load", "params", "policy", "scenario", "cell",
)


def _result(r):
    d = dataclasses.asdict(r)
    d.pop("sim_wall_s")
    return d


def _outcomes(records):
    return [{k: r[k] for k in _OUTCOME_KEYS} for r in records]


@pytest.mark.parametrize("n_jobs,n_nodes,seed,load", [
    (60, 16, 3, 1.5), (40, 8, 0, None), (25, 16, 7, 0.7)])
def test_trace_fingerprint_matches_reference(n_jobs, n_nodes, seed, load):
    ref = ref_trace(RefWorkload("lublin", n_jobs=n_jobs, n_nodes=n_nodes,
                                seed=seed, load=load))
    got = make_trace_ir(WorkloadSpec("lublin", n_jobs=n_jobs,
                                     n_nodes=n_nodes, seed=seed, load=load))
    assert got.fingerprint == ref.fingerprint
    carried = Trace.from_json_dict(ref.to_json_dict())
    assert carried.fingerprint == ref.fingerprint
    assert all(np.array_equal(getattr(carried, name), getattr(ref, name))
               for name, _ in COLUMNS)


@pytest.mark.parametrize("policy", SLICE_POLICIES)
def test_engine_equals_reference(policy):
    # a loaded trace: GreedyPM pauses 5 jobs and migrates 16 on it
    spec = dict(n_jobs=60, n_nodes=16, seed=5, load=2.0)
    ref = _result(RefEngine(ref_trace(RefWorkload("lublin", **spec)), policy,
                            RefParams(n_nodes=16)).run())
    tr = make_trace_ir(WorkloadSpec("lublin", **spec))
    host = _result(Engine(tr, policy, SimParams(n_nodes=16)).run())
    torch_cpu = _result(Engine(tr, policy, SimParams(n_nodes=16),
                               alloc_backend=TorchAllocBackend(device="cpu"))
                        .run())
    assert host == ref
    assert torch_cpu == ref


def test_api_simulate_cpu_equals_reference():
    spec = dict(n_jobs=50, n_nodes=16, seed=5, load=1.2)
    ref = _result(RefEngine(ref_trace(RefWorkload("lublin", **spec)),
                            "GreedyPM */OPT=MIN", RefParams(n_nodes=16)).run())
    got = _result(api.simulate(api.WorkloadSpec("lublin", **spec),
                               "GreedyPM */OPT=MIN", device="cpu"))
    assert got == ref


def test_run_batched_matches_reference_run_grid():
    """FCFS/EASY lanes that never allocate, OPT=MIN and OPT=AVG lanes share
    one lockstep schedule; every record equals the reference sweep's."""
    policies = ["FCFS", "EASY", "GreedyP */OPT=MIN", "Greedy */OPT=AVG",
                "EASY+OPT=MIN"]
    specs = [dict(n_jobs=40, n_nodes=16, seed=s, load=1.2) for s in range(2)]
    ref = ref_run_grid(ref_grid([RefWorkload("lublin", **s) for s in specs],
                                policies), compute_bound=True)
    got = run_batched(grid([WorkloadSpec("lublin", **s) for s in specs],
                           policies), compute_bound=True, device="cpu")
    assert _outcomes(got.records) == _outcomes(ref.records)
    assert [g["bound"] for g in got.records] == [r["bound"]
                                                 for r in ref.records]
    assert all(r["backend"] == "torch" for r in got.records)
    assert got.alloc_stats["dispatches"] > 0


def test_run_batched_bad_lane_raises_without_deadlock():
    cells = [Cell(WorkloadSpec("lublin", n_jobs=10, n_nodes=4, seed=0),
                  "GreedyP */OPT=MIN") for _ in range(2)]
    bad = [Cell(WorkloadSpec("lublin", n_jobs=10, n_nodes=4, seed=0),
                "NoSuchPolicy")]
    caught = []

    def drive():
        try:
            run_batched(bad + cells, device="cpu")
        except ValueError as exc:
            caught.append(exc)

    t = threading.Thread(target=drive, daemon=True)
    t.start()
    t.join(timeout=60)
    assert not t.is_alive(), "run_batched deadlocked"
    assert caught and "NoSuchPolicy" in str(caught[0])


# lanes that allocate on every event, lanes that skip a request on their
# /stretch-per ticks (OPT=MAX and OPT=AVG) and allocate again later while
# others are parked, MCB8 re-packs, and batch lanes that never allocate
MIXED_POLICIES = ["EASY", "GreedyPM */OPT=MIN",
                  "GreedyP */per/OPT=MIN/MINVT=600",
                  "MCB8 */OPT=MIN/MINVT=600", "/per/OPT=AVG",
                  "/stretch-per/OPT=MAX", "/stretch-per/OPT=AVG",
                  "GreedyPM */per/OPT=AVG/MINFT=300"]


@pytest.mark.parametrize("kind,spec", [
    ("lublin", dict(n_jobs=40, n_nodes=16, seed=1, load=1.2)),
    ("hpc2n", dict(n_jobs=60, n_nodes=16, seed=0))])
def test_run_batched_mcb8_family_matches_reference_run_grid(kind, spec):
    ref = ref_run_grid(ref_grid([RefWorkload(kind, **spec)], MIXED_POLICIES))
    got = run_batched(grid([WorkloadSpec(kind, **spec)], MIXED_POLICIES),
                      device="cpu")
    assert _outcomes(got.records) == _outcomes(ref.records)
    assert sum(r["n_mig"] for r in got.records) > 0
    assert got.alloc_stats["min_shapes"] and got.alloc_stats["avg_shapes"]


def test_run_batched_lublin_and_hpc2n_in_one_grid():
    """Lanes of both trace sets in one lockstep schedule."""
    ws = [dict(kind="lublin", n_jobs=30, n_nodes=16, seed=2, load=1.5),
          dict(kind="hpc2n", n_jobs=50, n_nodes=16, seed=3)]
    policies = ["EASY", "MCB8/per/OPT=MIN/MINVT=600", "/stretch-per/OPT=MAX",
                "GreedyPM */per/OPT=MIN/MINVT=600"]
    ref = ref_run_grid(ref_grid([RefWorkload(**w) for w in ws], policies))
    got = run_batched(grid([WorkloadSpec(**w) for w in ws], policies),
                      device="cpu")
    assert _outcomes(got.records) == _outcomes(ref.records)


@pytest.mark.parametrize("policy", ["MCB8 */OPT=MIN/MINVT=600",
                                    "/stretch-per/OPT=AVG"])
def test_api_simulate_cpu_mcb8_family_equals_reference(policy):
    spec = dict(n_jobs=40, n_nodes=16, seed=4)
    ref = _result(RefEngine(ref_trace(RefWorkload("hpc2n", **spec)), policy,
                            RefParams(n_nodes=16)).run())
    got = _result(api.simulate(api.WorkloadSpec("hpc2n", **spec), policy,
                               device="cpu"))
    assert got == ref
