"""The port's MCB8-stretch and the §4.7 post-passes
(``repro_torch.core.stretch_opt``) against the JAX package's, on seeded
instances: both packages get the same job states (the reference's
``JobState`` from seeded specs, virtual times and release times), and must
give equal mappings, yields, targets and removals.  The post-passes are
also held to the reference's oracle loops (``repro.core.alloc_reference``).
"""
import numpy as np
import pytest

from repro.core import alloc_reference
from repro.core.alloc_kernels import reference_kernels
from repro.core.greedy import greedy_place
from repro.core.job import JobSpec, JobState, NodePool
from repro.core.stretch_opt import improve_avg_stretch as ref_improve_avg
from repro.core.stretch_opt import improve_max_stretch as ref_improve_max
from repro.core.stretch_opt import mcb8_stretch as ref_mcb8_stretch

from repro_torch.core.stretch_opt import (improve_avg_stretch,
                                          improve_max_stretch, mcb8_stretch)

CPU_CHOICES = [0.25, 0.37, 0.5, 1.0]
MEM_CHOICES = [0.1, 0.2, 0.3, 0.5, 0.8, 1.0]
PERIOD = 600.0


def _specs(rng, n_max, max_tasks):
    return [JobSpec(jid=i, release=float(rng.uniform(0.0, 900.0)),
                    proc_time=float(rng.uniform(10.0, 1e4)),
                    n_tasks=int(rng.integers(1, max_tasks + 1)),
                    cpu_need=float(rng.choice(CPU_CHOICES)),
                    mem_req=float(rng.choice(MEM_CHOICES)))
            for i in range(int(rng.integers(1, n_max + 1)))]


def stretch_instance(seed):
    rng = np.random.default_rng(seed)
    n_nodes = int(rng.integers(2, 20))
    states = []
    # virtual time up to the flow time, as in a run; every third instance
    # has run at full speed (vt == ft), where a stretch-1 target can fit
    full_speed = seed % 3 == 0
    for spec in _specs(rng, 18, 16 if seed % 2 == 0 else 4):
        js = JobState(spec=spec)
        ft = 1000.0 - spec.release
        js.vt = ft if full_speed else ft * float(rng.uniform(0.3, 1.0))
        states.append(js)
    pinned = {}
    for js in states[: int(rng.integers(0, 3))]:
        if js.spec.n_tasks <= n_nodes:
            pinned[js.spec.jid] = sorted(
                rng.choice(n_nodes, js.spec.n_tasks, replace=False).tolist())
    alive = None
    if rng.random() < 0.3:
        alive = np.ones(n_nodes, dtype=bool)
        alive[rng.integers(0, n_nodes)] = False
    return states, n_nodes, pinned, alive


@pytest.mark.parametrize("seed", range(50))
def test_mcb8_stretch_equals_reference(seed):
    states, n_nodes, pinned, alive = stretch_instance(seed)
    now = 1000.0
    got = mcb8_stretch(states, n_nodes, now, PERIOD, pinned=pinned,
                       alive=alive)
    ref = ref_mcb8_stretch(states, n_nodes, now, PERIOD, pinned=pinned,
                           alive=alive)
    with reference_kernels():
        oracle = ref_mcb8_stretch(states, n_nodes, now, PERIOD,
                                  pinned=pinned, alive=alive)
    for other in (ref, oracle):
        assert got.mappings == other.mappings
        assert got.yields == other.yields
        assert got.target == other.target
        assert got.removed == other.removed
    assert list(got.mappings) == list(ref.mappings)
    assert list(got.yields) == list(ref.yields)


def test_stretch_instances_cover_removal_and_targets():
    removed = capped = lax = 0
    for seed in range(50):
        states, n_nodes, pinned, alive = stretch_instance(seed)
        res = mcb8_stretch(states, n_nodes, 1000.0, PERIOD, pinned=pinned,
                           alive=alive)
        removed += bool(res.removed)
        capped += res.target == 1.0
        lax += 1.0 < res.target < np.inf
    assert removed >= 5 and capped >= 5 and lax >= 5, (removed, capped, lax)


def placed_instance(seed):
    """Running jobs placed greedily, their mappings and starting yields."""
    rng = np.random.default_rng(70_000 + seed)
    n_nodes = int(rng.integers(2, 12))
    pool = NodePool(n_nodes)
    jobs, mappings, yields = [], {}, {}
    for spec in _specs(rng, 12, 4):
        m = greedy_place(pool, spec)
        if m is None:
            continue
        js = JobState(spec=spec)
        js.vt = float(rng.uniform(0.1, 500.0))
        jobs.append(js)
        mappings[spec.jid] = m
        yields[spec.jid] = float(rng.uniform(0.0, 0.6))
    return jobs, mappings, yields, n_nodes


@pytest.mark.parametrize("seed", range(40))
def test_improve_max_stretch_equals_reference(seed):
    jobs, mappings, yields, n_nodes = placed_instance(seed)
    got = improve_max_stretch(jobs, mappings, dict(yields), n_nodes,
                              now=1000.0, period=PERIOD)
    ref = ref_improve_max(jobs, mappings, dict(yields), n_nodes,
                          now=1000.0, period=PERIOD)
    oracle = alloc_reference.improve_max_stretch(
        jobs, mappings, dict(yields), n_nodes, now=1000.0, period=PERIOD)
    assert got == ref == oracle
    assert list(got) == list(ref)


@pytest.mark.parametrize("seed", range(25))
def test_improve_avg_stretch_equals_reference(seed):
    jobs, mappings, yields, n_nodes = placed_instance(seed)
    got = improve_avg_stretch(jobs, mappings, dict(yields), n_nodes,
                              now=1000.0, period=PERIOD)
    ref = ref_improve_avg(jobs, mappings, dict(yields), n_nodes,
                          now=1000.0, period=PERIOD)
    oracle = alloc_reference.improve_avg_stretch(
        jobs, mappings, dict(yields), n_nodes, now=1000.0, period=PERIOD)
    assert got == ref == oracle
    assert list(got) == list(ref)


def test_post_passes_raise_yields_where_there_is_slack():
    """The instances exercise the passes: some yields rise."""
    raised_max = raised_avg = 0
    for seed in range(25):
        jobs, mappings, yields, n_nodes = placed_instance(seed)
        mx = improve_max_stretch(jobs, mappings, dict(yields), n_nodes,
                                 now=1000.0, period=PERIOD)
        av = improve_avg_stretch(jobs, mappings, dict(yields), n_nodes,
                                 now=1000.0, period=PERIOD)
        raised_max += any(mx[j] > yields[j] for j in yields)
        raised_avg += any(av[j] > yields[j] for j in yields)
    assert raised_max >= 10 and raised_avg >= 10, (raised_max, raised_avg)
