"""Every policy of the paper's §6.1 space on the port's ``Engine`` against
the JAX package's: the same small, loaded Lublin trace gives a
``SimResult`` equal field for field.  The Table-2 entries that need MCB8
also run with the torch allocator on the CPU, and the periodic-only batch
backfill composition runs as in the reference's tests.
"""
import dataclasses

import pytest

from repro.core.policies import all_paper_policies
from repro.sched import components as ref_components
from repro.sched.engine import Engine as RefEngine, SimParams as RefParams
from repro.workloads.registry import (WorkloadSpec as RefWorkload,
                                      make_trace_ir as ref_trace)

from repro_torch.core.alloc_torch import TorchAllocBackend
from repro_torch.sched import components
from repro_torch.sched.engine import Engine, SimParams
from repro_torch.workloads.registry import WorkloadSpec, make_trace_ir

# a loaded trace: the 116 policies migrate 2,393 times on it in all
SPEC = dict(n_jobs=30, n_nodes=8, seed=5, load=1.5)

# the Table-2 policies that run MCB8 (benchmarks/common.py TABLE2_POLICIES)
TABLE2_MCB8 = [
    "Greedy/per/OPT=MIN",
    "GreedyP/per/OPT=MIN/MINVT=600",
    "GreedyPM/per/OPT=MIN/MINVT=600",
    "GreedyP */per/OPT=MIN/MINVT=600",
    "GreedyPM */per/OPT=MIN/MINVT=600",
    "MCB8 */OPT=MIN/MINVT=600",
    "MCB8/per/OPT=MIN/MINVT=600",
    "/per/OPT=MIN",
    "/stretch-per/OPT=MAX",
]


def _result(r):
    d = dataclasses.asdict(r)
    d.pop("sim_wall_s")
    return d


def _reference(policy, params=None):
    return _result(RefEngine(ref_trace(RefWorkload("lublin", **SPEC)), policy,
                             params or RefParams(n_nodes=SPEC["n_nodes"]))
                   .run())


def _trace():
    return make_trace_ir(WorkloadSpec("lublin", **SPEC))


def test_the_paper_space_has_116_policies():
    assert len(all_paper_policies()) == 116
    assert set(TABLE2_MCB8) <= set(all_paper_policies())


@pytest.mark.parametrize("policy", all_paper_policies())
def test_engine_equals_reference_on_every_paper_policy(policy):
    got = _result(Engine(_trace(), policy,
                         SimParams(n_nodes=SPEC["n_nodes"])).run())
    assert got == _reference(policy)


@pytest.mark.parametrize("policy", TABLE2_MCB8)
def test_table2_mcb8_policies_with_the_torch_allocator(policy):
    backend = TorchAllocBackend(device="cpu")
    got = _result(Engine(_trace(), policy, SimParams(n_nodes=SPEC["n_nodes"]),
                         alloc_backend=backend).run())
    assert got == _reference(policy)
    assert backend.stats["dispatches"] > 0


def _periodic_backfill(mod):
    return mod.compose(
        "periodic-backfill",
        mod.get_component("submit", "fcfs-queue")(),
        mod.get_component("complete", "reclaim")(),
        mod.get_component("periodic", "backfill")(),
    )


@pytest.mark.parametrize("period", [300.0, 600.0])
def test_periodic_backfill_equals_reference(period):
    """The batch queue drained only on the periodic tick: equal to the
    reference's composition, and never earlier than EASY on events."""
    pol = _periodic_backfill(components)
    assert pol.periodic_kind == "backfill"
    params = SimParams(n_nodes=SPEC["n_nodes"], period=period)
    got = _result(Engine(_trace(), pol, params).run())
    ref = _result(RefEngine(
        ref_trace(RefWorkload("lublin", **SPEC)),
        _periodic_backfill(ref_components),
        RefParams(n_nodes=SPEC["n_nodes"], period=period)).run())
    assert got == ref
    easy = _result(Engine(_trace(), "EASY", params).run())
    assert got["makespan"] >= easy["makespan"] - 1e-9
