"""Named scenarios in the port (``repro_torch.sched.scenarios``) against
the JAX package's, on the CPU.

Every built-in transform and a chain, applied to the same seeded traces,
must give equal traces (fingerprints, hence every column) and equal
cluster scripts; scenario cells run through ``run_grid`` — in lockstep on
``device="cpu"`` and on the host — must equal the reference's serial
``run_grid`` record for record; the reactive rules must drive equal
sessions.  Outcome fields are compared exactly (bit for bit).
"""
import dataclasses

import pytest

from repro.sched.scenarios import apply_scenario as ref_apply_scenario
from repro.sched.scenarios import apply_scenario_trace as ref_apply
from repro.sched.scenarios import list_scenarios as ref_list_scenarios
from repro.sched.scenarios import run_reactive as ref_run_reactive
from repro.sched.scenarios import scenario_docs as ref_scenario_docs
from repro.sched.session import open_session as ref_open_session
from repro.sched.sweep import grid as ref_grid
from repro.sched.sweep import run_grid as ref_run_grid
from repro.workloads.registry import WorkloadSpec as RefWorkload
from repro.workloads.registry import make_trace_ir as ref_trace

from repro_torch.sched import sweep as sweep_mod
from repro_torch.sched.scenarios import (SCENARIOS, apply_scenario,
                                         apply_scenario_trace,
                                         list_reactive, list_scenarios,
                                         parse_scenario_chain,
                                         register_scenario, run_reactive,
                                         scenario_docs)
from repro_torch.sched.session import open_session
from repro_torch.sched.sweep import grid, run_grid
from repro_torch.workloads.registry import WorkloadSpec, make_trace_ir

CPU = dict(device="cpu")
_CLOCKS = ("wall_s", "sim_wall_s", "backend")
CHAINS = ["rack_failure+arrival_burst", "arrival_burst+mem_pressure",
          "ptime_noise+mem_pressure+ptime_noise"]
WORKLOADS = [dict(kind="lublin", n_jobs=40, n_nodes=16, seed=1, load=0.8),
             dict(kind="tpu", n_jobs=80, n_nodes=32, seed=2)]


def _outcomes(records):
    return [{k: v for k, v in r.items() if k not in _CLOCKS}
            for r in records]


def _events(events):
    return [(e.time, e.kind, tuple(e.nodes), tuple(e.jids), e.value)
            for e in events]


def test_builtins_and_docs_equal_reference():
    assert list_scenarios() == ref_list_scenarios()
    assert {"baseline", "rack_failure", "rolling_failures", "elastic",
            "arrival_burst", "mem_pressure",
            "ptime_noise"} <= set(list_scenarios())
    assert scenario_docs() == ref_scenario_docs()
    assert list_reactive() == ["elastic_reserve", "surge_submit"]


@pytest.mark.parametrize("w", WORKLOADS, ids=lambda w: w["kind"])
@pytest.mark.parametrize("name", ["baseline", "rack_failure",
                                  "rolling_failures", "elastic",
                                  "arrival_burst", "mem_pressure",
                                  "ptime_noise"] + CHAINS)
def test_transform_equals_reference(name, w):
    mine, my_events = apply_scenario_trace(
        name, make_trace_ir(WorkloadSpec(**w)), w["n_nodes"], seed=5)
    theirs, their_events = ref_apply(
        name, ref_trace(RefWorkload(**w)), w["n_nodes"], seed=5)
    assert mine.fingerprint == theirs.fingerprint
    assert _events(my_events) == _events(their_events)


def test_spec_list_wrapper_equals_reference():
    w = WORKLOADS[0]
    specs = make_trace_ir(WorkloadSpec(**w)).to_specs()
    mine, my_events = apply_scenario("rack_failure+ptime_noise", specs,
                                     w["n_nodes"], seed=3)
    theirs, their_events = ref_apply_scenario(
        "rack_failure+ptime_noise", ref_trace(RefWorkload(**w)).to_specs(),
        w["n_nodes"], seed=3)
    assert ([dataclasses.astuple(s) for s in mine]
            == [dataclasses.astuple(s) for s in theirs])
    assert _events(my_events) == _events(their_events)


def test_chain_grammar_and_registry_errors():
    assert parse_scenario_chain(" rack_failure + elastic ") == \
        ["rack_failure", "elastic"]
    for bad in ("", "rack_failure+", "nope", "baseline+nope"):
        with pytest.raises(KeyError):
            parse_scenario_chain(bad)
    with pytest.raises(ValueError, match="reserved"):
        register_scenario("a+b")
    with pytest.raises(ValueError, match="already registered"):
        register_scenario("baseline")(lambda tr, n, rng: (tr, []))
    assert "baseline" in SCENARIOS


def test_scenario_cells_equal_reference_on_both_paths():
    """A grid of every built-in over one Lublin trace: in lockstep on the
    CPU and on the host, equal to the reference's serial run_grid,
    Theorem-1 bound and degradation included."""
    w = WORKLOADS[0]
    scenarios = ref_list_scenarios() + CHAINS[:1]
    policies = ["GreedyP */OPT=MIN", "EASY"]
    ref = ref_run_grid(ref_grid([RefWorkload(**w)], policies, scenarios),
                       compute_bound=True)
    cells = grid([WorkloadSpec(**w)], policies, scenarios)
    dev = run_grid(cells, compute_bound=True, **CPU)
    host = run_grid(cells, compute_bound=True, backend="numpy")
    assert _outcomes(dev.records) == _outcomes(ref.records)
    assert _outcomes(host.records) == _outcomes(ref.records)
    assert all("bound" in r and "degradation" in r for r in dev.records)
    easy_fail = dev.filter(policy="EASY", scenario="rack_failure")[0]
    assert not easy_fail["scenario_applied"]


def test_two_runs_in_one_process_are_equal():
    """Lane threads share the cell memo and the registry's trace memo: the
    transforms must never write into the memoized base trace."""
    w = WorkloadSpec(**WORKLOADS[1])
    base = make_trace_ir(w)
    fp, cols = base.fingerprint, base.mem_req.copy()
    cells = grid([w], ["GreedyP */OPT=MIN"],
                 ["mem_pressure", "ptime_noise", "arrival_burst+mem_pressure",
                  "baseline"])
    a = run_grid(cells, **CPU)
    sweep_mod._CELL_CACHE.clear()
    b = run_grid(cells, **CPU)
    assert _outcomes(a.records) == _outcomes(b.records)
    assert make_trace_ir(w) is base and base.fingerprint == fp
    assert (base.mem_req == cols).all() and base.proc_truth is None
    assert not base.mem_req.flags.writeable


def _reactive(open_fn, run_fn, rule, policy, **kw):
    ses = open_fn(16, policy, **kw)
    ses.submit(make_trace_ir(WorkloadSpec(**WORKLOADS[0])).to_specs())
    r = run_fn(ses, rule, seed=4)
    d = dataclasses.asdict(r)
    d.pop("sim_wall_s")
    return d, ses.observe()


@pytest.mark.parametrize("where", [dict(alloc_backend="numpy"), CPU],
                         ids=["numpy", "cpu"])
@pytest.mark.parametrize("rule", ["surge_submit", "elastic_reserve"])
def test_run_reactive_equals_reference(rule, where):
    mine, obs = _reactive(open_session, run_reactive, rule,
                          "GreedyP */OPT=MIN", **where)
    theirs, ref_obs = _reactive(ref_open_session, ref_run_reactive, rule,
                                "GreedyP */OPT=MIN")
    assert mine == theirs
    assert obs["n_completed"] == ref_obs["n_completed"]
    if rule == "surge_submit":
        assert len(mine["completions"]) > WORKLOADS[0]["n_jobs"]


def test_run_reactive_errors():
    ses = open_session(16, "EASY", alloc_backend="numpy")
    ses.submit(make_trace_ir(WorkloadSpec(**WORKLOADS[0])).to_specs())
    with pytest.raises(KeyError, match="unknown reactive"):
        run_reactive(ses, "nope")
    with pytest.raises(ValueError, match="interval"):
        run_reactive(ses, "surge_submit", interval=0.0)
    with pytest.raises(ValueError, match="cluster events"):
        run_reactive(ses, "elastic_reserve")
