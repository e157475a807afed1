"""The monolithic seed policies (``DFRSPolicy``, ``BatchPolicy``,
``make_seed_policy``) and the other names the port's first copies dropped
(``JobState``, ``rebuild_pool``, ``min_yield``, the trace memo's
``trace_cache_info`` / ``trace_cache_clear``, the live ``WORKLOAD_KINDS``
view), against the JAX package, on the CPU.

The seed classes are the golden oracle of the policy components: on the
policies and traces of the reference's ``tests/test_components.py`` (every
Table-1 policy with FCFS and EASY on a 30-job Lublin trace, and its
17-cell acceptance grid with failure scenarios), the port's components
must give ``SimResult``s bit-identical to the port's seed classes, and
those must equal the reference's seed classes.  Sessions under a seed
policy snapshot its private state as the reference does (``batch-seed``,
``dfrs-seed``) and restore it verbatim.
"""
import json

import numpy as np
import pytest

from conftest import result_dict

from repro import api as ref_api
from repro.core import job as ref_job
from repro.core import yield_alloc as ref_yield
from repro.core.policies import TABLE1_POLICIES
from repro.core.policies import parse_policy as ref_parse
from repro.sched import components as ref_components
from repro.sched.engine import Engine as RefEngine
from repro.sched.engine import SimParams as RefParams
from repro.sched.engine import make_seed_policy as ref_seed
from repro.sched.scenarios import apply_scenario as ref_apply_scenario
from repro.sched.session import SimSession as RefSession
from repro.workloads import registry as ref_registry

from repro_torch import api
from repro_torch.core import job
from repro_torch.core.alloc_torch import TorchAllocBackend
from repro_torch.core.policies import parse_policy
from repro_torch.core.yield_alloc import min_yield
from repro_torch.sched import components
from repro_torch.sched.engine import (BatchPolicy, DFRSPolicy, Engine,
                                      SimParams, make_seed_policy)
from repro_torch.sched.scenarios import apply_scenario
from repro_torch.sched.session import SimSession
from repro_torch.workloads import registry
from repro_torch.workloads.registry import WorkloadSpec, make_trace

CPU = dict(device="cpu")


def _mini(n=30, nodes=16, seed=0):
    w = dict(n_jobs=n, n_nodes=nodes, seed=seed)
    return (make_trace(WorkloadSpec("lublin", **w)),
            ref_registry.make_trace(ref_registry.WorkloadSpec("lublin", **w)))


# --------------------------------------------------------------------------- #
# the components against the seed classes (tests/test_components.py's cases) #
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("policy", TABLE1_POLICIES + ["FCFS", "EASY"])
def test_every_table1_policy_composed_equals_seed(policy):
    specs, ref_specs = _mini()
    params = SimParams(n_nodes=16)
    composed = Engine(specs, policy, params).run()
    seed = Engine(specs, make_seed_policy(parse_policy(policy)), params).run()
    assert result_dict(composed) == result_dict(seed)
    ref = RefEngine(ref_specs, ref_seed(ref_parse(policy)),
                    RefParams(n_nodes=16)).run()
    assert result_dict(seed) == result_dict(ref)


GOLDEN_POLICIES = ["FCFS", "EASY", "GreedyP */OPT=MIN",
                   "GreedyPM */per/OPT=MIN/MINVT=600"]
GOLDEN_WORKLOADS = [dict(kind="lublin", n_jobs=40, n_nodes=16, seed=0),
                    dict(kind="hpc2n", n_jobs=40, n_nodes=128, seed=1)]
GOLDEN_CASES = [(w, p, sc) for w in GOLDEN_WORKLOADS
                for p in GOLDEN_POLICIES
                for sc in ("baseline", "rack_failure")]
GOLDEN_CASES.append((GOLDEN_WORKLOADS[0], "/stretch-per/OPT=MAX", "baseline"))


@pytest.mark.parametrize(
    "workload,policy,scenario", GOLDEN_CASES,
    ids=[f"{w['kind']}-{p}-{sc}" for w, p, sc in GOLDEN_CASES])
def test_golden_composed_vs_seed_simresult(workload, policy, scenario):
    n, seed = workload["n_nodes"], workload["seed"]
    specs, events = apply_scenario(
        scenario, make_trace(WorkloadSpec(**workload)), n, seed=seed)
    params = SimParams(n_nodes=n)
    composed = Engine(specs, policy, params, cluster_events=events).run()
    seeded = Engine(specs, make_seed_policy(parse_policy(policy)), params,
                    cluster_events=events).run()
    assert result_dict(composed) == result_dict(seeded)
    # and the port's seed class equals the reference's, on its device path
    rspecs, revents = ref_apply_scenario(
        scenario, ref_registry.make_trace(ref_registry.WorkloadSpec(
            **workload)), n, seed=seed)
    ref = RefEngine(rspecs, ref_seed(ref_parse(policy)), RefParams(n_nodes=n),
                    cluster_events=revents).run()
    on_torch = Engine(specs, make_seed_policy(parse_policy(policy)), params,
                      cluster_events=events,
                      alloc_backend=TorchAllocBackend(**CPU)).run()
    assert result_dict(on_torch) == result_dict(ref) == result_dict(seeded)


def test_seed_classes_are_the_monolithic_ones():
    assert isinstance(make_seed_policy(parse_policy("EASY")), BatchPolicy)
    assert isinstance(make_seed_policy(parse_policy("FCFS")), BatchPolicy)
    pol = make_seed_policy(parse_policy("GreedyPM */per/OPT=MIN"))
    assert isinstance(pol, DFRSPolicy) and pol.periodic_kind == "mcb8"
    with pytest.raises(ValueError, match="BatchPolicy"):
        DFRSPolicy(parse_policy("EASY"))
    with pytest.raises(ValueError):
        BatchPolicy("SJF")
    # the result names the policy as the reference's does
    specs, ref_specs = _mini(n=10)
    for name in ("EASY", "GreedyP */OPT=MIN"):
        got = Engine(specs, make_seed_policy(parse_policy(name)),
                     SimParams(n_nodes=16)).run().policy
        want = RefEngine(ref_specs, ref_seed(ref_parse(name)),
                         RefParams(n_nodes=16)).run().policy
        assert got == want


# --------------------------------------------------------------------------- #
# sessions under a seed policy                                                 #
# --------------------------------------------------------------------------- #
SESSION_POLICIES = ["EASY", "FCFS", "GreedyP */OPT=MIN",
                    "GreedyPM */per/OPT=MIN/MINVT=600",
                    "/stretch-per/OPT=MAX"]


@pytest.fixture
def seed_names():
    """Each session policy's seed class under a registered name in both
    packages, so a snapshot carries a rebuildable reference to it;
    unregistered afterwards."""
    names = {}
    for policy in SESSION_POLICIES:
        name = "seed-oracle:" + policy
        components.register_policy(
            name, lambda p=policy: make_seed_policy(parse_policy(p)))
        ref_components.register_policy(
            name, lambda p=policy: ref_seed(ref_parse(p)))
        names[policy] = name
    yield names
    for name in names.values():
        components._POLICIES.pop(name, None)
        ref_components._POLICIES.pop(name, None)


def _payload(ses):
    ses._wall = 0.0
    return json.loads(json.dumps(ses.snapshot().payload, sort_keys=True))


@pytest.mark.parametrize("policy", SESSION_POLICIES)
def test_seed_session_snapshot_and_restore_equal_the_reference(policy,
                                                               seed_names):
    name = seed_names[policy]
    specs, ref_specs = _mini(n=40, nodes=16, seed=2)
    ses = SimSession.from_engine(Engine(
        specs, name, SimParams(n_nodes=16),
        alloc_backend=TorchAllocBackend(**CPU)))
    ref = RefSession.from_engine(RefEngine(ref_specs, name,
                                           RefParams(n_nodes=16)))
    whole = Engine(specs, make_seed_policy(parse_policy(policy)),
                   SimParams(n_nodes=16)).run()
    ses.step(25)
    ref.step(25)
    pl, rpl = _payload(ses), _payload(ref)
    assert pl == rpl
    kind = "batch-seed" if policy in ("EASY", "FCFS") else "dfrs-seed"
    assert pl["policy"] == name and pl["policy_state"]["kind"] == kind
    if kind == "batch-seed":
        assert pl["policy_state"]["queue"] or pl["policy_state"]["running"]
    # verbatim restores, each package's snapshot in both packages
    back = SimSession.restore(ses.snapshot(), **CPU)
    ref_back = RefSession.restore(ref.snapshot())
    crossed = SimSession.restore(ref.snapshot().to_json_dict(), **CPU)
    assert isinstance(back.engine.policy,
                      BatchPolicy if kind == "batch-seed" else DFRSPolicy)
    got = result_dict(back.run())
    assert got == result_dict(ref_back.run()) == result_dict(crossed.run())
    assert got == result_dict(ses.run()) == result_dict(whole)


def test_seed_state_on_a_composed_policy_is_a_clear_error(seed_names):
    specs, _ = _mini(n=20, nodes=8)
    ses = SimSession.from_engine(Engine(
        specs, seed_names["EASY"], SimParams(n_nodes=8),
        alloc_backend=TorchAllocBackend(**CPU)))
    ses.step(5)
    pl = {**ses.snapshot().payload, "policy": "EASY"}
    with pytest.raises(ValueError, match="BatchPolicy"):
        SimSession.restore(pl, **CPU)
    # a fork onto the seed class adopts nothing (oracle-only), as in the
    # reference; a fork onto the composed spelling runs on
    with pytest.raises(TypeError, match="oracle-only"):
        SimSession.restore(ses.snapshot(), policy=seed_names["EASY"], **CPU)
    assert SimSession.restore(ses.snapshot(), policy="EASY", **CPU).run()


# --------------------------------------------------------------------------- #
# JobState, rebuild_pool, min_yield                                            #
# --------------------------------------------------------------------------- #
def _job_states(mod, seed):
    rng = np.random.default_rng(seed)
    out = {}
    for jid in range(12):
        spec = mod.JobSpec(jid=jid, release=float(rng.uniform(0, 100)),
                           proc_time=float(rng.uniform(10, 1000)),
                           n_tasks=int(rng.integers(1, 4)),
                           cpu_need=float(rng.uniform(0.1, 1.0)),
                           mem_req=float(rng.uniform(0.01, 0.2)))
        status = [mod.PENDING, mod.RUNNING, mod.PAUSED][jid % 3]
        mapping = ([int(n) for n in rng.integers(0, 8, spec.n_tasks)]
                   if status == mod.RUNNING or jid % 4 == 0 else None)
        out[jid] = mod.JobState(spec, status=status,
                                vt=float(rng.choice([0.0, rng.uniform(1, 9)])),
                                mapping=mapping)
    return out


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_job_state_and_rebuild_pool_equal_the_reference(seed):
    mine, ref = _job_states(job, seed), _job_states(ref_job, seed)
    for now in (50.0, 500.0):
        for jid in mine:
            a, b = mine[jid], ref[jid]
            assert a.flow_time(now) == b.flow_time(now)
            assert a.priority(now) == b.priority(now)
            assert a.priority_key(now) == b.priority_key(now)
            assert a.remaining_vt() == b.remaining_vt()
            assert a.is_running == b.is_running
    assert job.JobState(mine[0].spec).penalty_until == -np.inf
    pool, ref_pool = job.rebuild_pool(8, mine), ref_job.rebuild_pool(8, ref)
    np.testing.assert_array_equal(pool.load, ref_pool.load)
    np.testing.assert_array_equal(pool.mem_free, ref_pool.mem_free)
    assert pool.max_load() == ref_pool.max_load()
    assert [pool.fits(mine[j].spec, n) for j in mine for n in range(8)] == \
        [ref_pool.fits(ref[j].spec, n) for j in ref for n in range(8)]


@pytest.mark.parametrize("load", [0.0, 0.5, 1.0, 1.0 + 1e-12, 2.5, 1e9])
def test_min_yield_equals_the_reference(load):
    assert min_yield(load) == ref_yield.min_yield(load)


# --------------------------------------------------------------------------- #
# the trace memo and the live WORKLOAD_KINDS view                              #
# --------------------------------------------------------------------------- #
def test_trace_cache_info_and_clear_equal_the_reference():
    spec = dict(kind="lublin", n_jobs=20, n_nodes=8, seed=3)
    counts = []
    for reg in (registry, ref_registry):
        reg.trace_cache_clear()
        first = reg.make_trace_ir(reg.WorkloadSpec(**spec))
        assert reg.make_trace_ir(reg.WorkloadSpec(**spec)) is first
        reg.make_trace_ir(reg.WorkloadSpec(**{**spec, "seed": 4}))
        info = reg.trace_cache_info()
        counts.append((info.hits, info.misses, info.maxsize, info.currsize))
        reg.trace_cache_clear()
        assert reg.trace_cache_info().currsize == 0
    assert counts[0] == counts[1] == (1, 2, 64, 2)


def test_workload_kinds_is_a_live_view():
    assert registry.WORKLOAD_KINDS == api.WORKLOAD_KINDS == tuple(
        registry.list_workloads())
    assert set(ref_api.WORKLOAD_KINDS) == set(api.WORKLOAD_KINDS)
    assert "WORKLOAD_KINDS" in api.__all__
    name = "seed-oracle-kind"
    try:
        @registry.register_workload(name)
        def _kind(spec):
            return registry.make_trace_ir(WorkloadSpec(
                "lublin", n_jobs=spec.n_jobs, n_nodes=spec.n_nodes))
        assert name in registry.WORKLOAD_KINDS
        assert name in api.WORKLOAD_KINDS
        assert name not in ref_api.WORKLOAD_KINDS
    finally:
        registry._REGISTRY.pop(name, None)
    assert name not in api.WORKLOAD_KINDS
    with pytest.raises(AttributeError):
        registry.NO_SUCH_NAME
