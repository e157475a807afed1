"""The port's legacy entry points (``sched/simulator.py``: ``DFRSSimulator``
and ``simulate``; ``sched/batch.py``: ``batch_schedule``) against the JAX
package's, on the CPU (``device="cpu"``: the kernels' plain versions behind
``TorchAllocBackend``).  Results are bit-exact against the reference's
wrappers and each wrapper warns once per process, as the reference's do.
Their device default (the card, raising without one) is held in
``test_torch_isolation.py``."""
import warnings

import pytest

from conftest import result_dict

from repro.sched import _compat as ref_compat
from repro.sched.batch import batch_schedule as ref_batch
from repro.sched.engine import SimParams as RefParams
from repro.sched.simulator import DFRSSimulator as RefDFRS
from repro.sched.simulator import simulate as ref_simulate
from repro.workloads.registry import WorkloadSpec as RefWorkload
from repro.workloads.registry import make_trace as ref_make_trace

from repro_torch import sched
from repro_torch.sched import _compat
from repro_torch.sched.batch import batch_schedule
from repro_torch.sched.cluster import ClusterEvent
from repro_torch.sched.engine import SimParams
from repro_torch.sched.simulator import DFRSSimulator, simulate
from repro_torch.workloads.registry import WorkloadSpec, make_trace

W = dict(kind="lublin", n_jobs=50, n_nodes=16, seed=2, load=1.0)
CPU = {"device": "cpu"}


def _specs():
    return make_trace(WorkloadSpec(**W)), ref_make_trace(RefWorkload(**W))


def _quiet(fn, *a, **kw):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        return fn(*a, **kw)


@pytest.mark.parametrize("policy", ["GreedyP */OPT=MIN", "Greedy */OPT=AVG",
                                    "GreedyPM */per/OPT=MIN/MINVT=600",
                                    "FCFS", "EASY"])
def test_simulate_equals_reference(policy):
    specs, ref_specs = _specs()
    got = _quiet(simulate, specs, policy, SimParams(n_nodes=16), **CPU)
    ref = _quiet(ref_simulate, ref_specs, policy, RefParams(n_nodes=16))
    assert result_dict(got) == result_dict(ref)


def test_simulate_with_cluster_events_equals_reference():
    from repro.sched.cluster import ClusterEvent as RefEvent
    specs, ref_specs = _specs()
    ev = [ClusterEvent(time=3000.0, kind="fail", nodes=(0, 1, 2))]
    ref_ev = [RefEvent(time=3000.0, kind="fail", nodes=(0, 1, 2))]
    got = _quiet(simulate, specs, "GreedyP */OPT=MIN", SimParams(n_nodes=16),
                 ev, **CPU)
    ref = _quiet(ref_simulate, ref_specs, "GreedyP */OPT=MIN",
                 RefParams(n_nodes=16), ref_ev)
    assert result_dict(got) == result_dict(ref)


@pytest.mark.parametrize("policy", ["GreedyP */OPT=MIN", "MCB8 */OPT=AVG"])
def test_dfrs_simulator_equals_reference(policy):
    specs, ref_specs = _specs()
    got = _quiet(DFRSSimulator, specs, policy, SimParams(n_nodes=16), **CPU)
    assert got.alloc_backend is not None            # allocates on device
    ref = _quiet(RefDFRS, ref_specs, policy, RefParams(n_nodes=16))
    assert result_dict(got.run()) == result_dict(ref.run())


@pytest.mark.parametrize("algo", ["FCFS", "EASY"])
def test_batch_schedule_equals_reference(algo):
    specs, ref_specs = _specs()
    got = _quiet(batch_schedule, specs, algo, SimParams(n_nodes=16), **CPU)
    ref = _quiet(ref_batch, ref_specs, algo, RefParams(n_nodes=16))
    assert result_dict(got) == result_dict(ref)


def test_wrappers_refuse_the_other_family_as_the_reference_does():
    specs, ref_specs = _specs()
    with pytest.raises(ValueError, match="repro_torch.sched.batch"):
        _quiet(DFRSSimulator, specs, "EASY", **CPU)
    with pytest.raises(ValueError):
        _quiet(RefDFRS, ref_specs, "EASY")
    with pytest.raises(ValueError):
        _quiet(batch_schedule, specs, "GreedyP */OPT=MIN", **CPU)
    with pytest.raises(ValueError):
        _quiet(ref_batch, ref_specs, "GreedyP */OPT=MIN")


def _deprecations(record):
    return [w for w in record
            if issubclass(w.category, DeprecationWarning)
            and "repro_torch.api" in str(w.message)]


@pytest.mark.parametrize("name", ["simulate", "batch_schedule",
                                  "DFRSSimulator"])
def test_each_wrapper_warns_exactly_once(name):
    specs, ref_specs = _specs()
    calls = {
        "simulate": (lambda: simulate(specs, "FCFS", SimParams(n_nodes=16),
                                      **CPU),
                     lambda: ref_simulate(ref_specs, "FCFS",
                                          RefParams(n_nodes=16))),
        "batch_schedule": (
            lambda: batch_schedule(specs, "EASY", SimParams(n_nodes=16),
                                   **CPU),
            lambda: ref_batch(ref_specs, "EASY", RefParams(n_nodes=16))),
        "DFRSSimulator": (
            lambda: DFRSSimulator(specs, "GreedyP */OPT=MIN",
                                  SimParams(n_nodes=16), **CPU),
            lambda: RefDFRS(ref_specs, "GreedyP */OPT=MIN",
                            RefParams(n_nodes=16))),
    }
    port_call, ref_call = calls[name]
    _compat.reset()
    ref_compat.reset()
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        port_call()
        port_call()
    ours = _deprecations(rec)
    assert len(ours) == 1 and name in str(ours[0].message)
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        ref_call()
        ref_call()
    assert len([w for w in rec
                if issubclass(w.category, DeprecationWarning)]) == 1


def test_api_simulate_does_not_warn_and_wrappers_are_exported():
    _compat.reset()
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        from repro_torch import api
        api.simulate(WorkloadSpec(**W), "FCFS", **CPU)
    assert not _deprecations(rec)
    assert sched.simulate is simulate
    assert sched.DFRSSimulator is DFRSSimulator
    assert sched.batch_schedule is batch_schedule
