"""The port's MCB8 packing and allocation (``repro_torch.core.mcb8``)
against the JAX package's, on seeded instances.

Three sides meet on every instance: the port, the reference's fast packer
(``repro.core.mcb8``) and the reference's oracle packer
(``repro.core.alloc_reference.pack_core``, reached through
``reference_kernels()``).  The instances mix pinned jobs, a masked ``alive``
vector, infeasible sets, single-task and many-task jobs; the tolerance is
equality.
"""
import numpy as np
import pytest

from repro.core import alloc_reference
from repro.core.alloc_kernels import reference_kernels
from repro.core.job import JobSpec, JobState
from repro.core.mcb8 import _pack_core as ref_pack_core
from repro.core.mcb8 import _try_pack as ref_try_pack
from repro.core.mcb8 import mcb8 as ref_mcb8
from repro.core.mcb8 import mcb8_pack as ref_mcb8_pack

from repro_torch.core.mcb8 import Y_FLOOR, _pack_core, _try_pack, mcb8, mcb8_pack

CPU_CHOICES = [0.25, 0.37, 0.5, 1.0]
MEM_CHOICES = [0.1, 0.2, 0.3, 0.5, 0.8, 1.0]
N_PACK = 240            # seeded pack instances (4 a test case)
N_FULL = 60             # seeded full-MCB8 instances


# offsets from an exact fit that fall on either side of the packer's 1e-9
# tolerance
_NEAR = [-3e-7, -4e-9, -5e-10, 0.0, 5e-10, 4e-9, 3e-7]


def _value(rng, choices):
    """A catalogue value (ties between jobs), a near-exact share of a node
    (1/m off by a hair: packs that fit or fail only by the tolerance), or a
    free one (no ties)."""
    u = rng.random()
    if u < 0.35:
        return float(rng.choice(choices))
    if u < 0.7:
        return min(1.0, 1.0 / int(rng.integers(1, 6)) + float(rng.choice(_NEAR)))
    return float(rng.uniform(0.02, 1.0))


def pack_instance(seed):
    """Items in candidate order, pinned jobs with their mappings, and an
    optional ``alive`` mask with dead nodes."""
    rng = np.random.default_rng(seed)
    n_nodes = int(rng.integers(1, 20))
    n = int(rng.integers(1, 25))
    many = seed % 2 == 0
    y = float(rng.uniform(Y_FLOOR, 1.0))
    jid = rng.permutation(np.arange(100, 100 + n)).astype(np.int64)
    # yield-scaled needs, or a near-exact share unscaled
    cpu = np.array([min(1.0, _value(rng, CPU_CHOICES) * y) if rng.random() < 0.5
                    else min(1.0, _value(rng, CPU_CHOICES)) for _ in range(n)])
    mem = np.array([_value(rng, MEM_CHOICES) for _ in range(n)])
    ntask = rng.integers(1, 17 if many else 2, n).astype(np.int64)
    pins = {}
    for k in range(int(rng.integers(0, 3))):
        width = int(rng.integers(1, 4))
        mapping = rng.integers(0, n_nodes, width).tolist()
        pins[k] = (float(rng.uniform(0.05, 0.6)),
                   float(rng.uniform(0.05, 0.5)), mapping)
    alive = None
    if rng.random() < 0.3:
        alive = rng.random(n_nodes) > 0.25
    return n_nodes, jid, cpu, mem, ntask, pins, alive


def _same(a, b):
    """Equal mappings, with the dict's key order."""
    if a is None or b is None:
        return a is b
    return a == b and list(a) == list(b)


def test_pack_instances_cover_every_case():
    """The seeded set holds feasible and infeasible packs, pinned jobs,
    dead nodes, and single- and many-task jobs."""
    seen = {"feasible": 0, "infeasible": 0, "pinned": 0, "dead": 0,
            "many_task": 0, "single_task": 0}
    for seed in range(N_PACK):
        n_nodes, jid, cpu, mem, ntask, pins, alive = pack_instance(seed)
        out = _try_pack(n_nodes, jid, cpu, mem, ntask, pins, alive)
        seen["feasible" if out is not None else "infeasible"] += 1
        seen["pinned"] += bool(pins)
        seen["dead"] += alive is not None and not alive.all()
        seen["many_task"] += bool((ntask > 1).any())
        seen["single_task"] += bool((ntask == 1).all())
    assert all(v >= 20 for v in seen.values()), seen


@pytest.mark.parametrize("block", range(N_PACK // 4))
def test_try_pack_equals_reference_and_oracle(block):
    for seed in range(4 * block, 4 * block + 4):
        n_nodes, jid, cpu, mem, ntask, pins, alive = pack_instance(seed)
        got = _try_pack(n_nodes, jid, cpu, mem, ntask, pins, alive)
        ref = ref_try_pack(n_nodes, jid, cpu, mem, ntask, pins, alive)
        with reference_kernels():
            oracle = ref_try_pack(n_nodes, jid, cpu, mem, ntask, pins, alive)
        assert _same(got, ref), seed
        assert got == oracle, seed


@pytest.mark.parametrize("block", range(N_PACK // 8))
def test_pack_core_equals_reference_and_oracle(block):
    """The packing core on free capacities left by earlier placements
    (dead nodes at -1), with pre-placed jobs merged into the result."""
    for seed in range(8 * block, 8 * block + 8):
        n_nodes, jid, cpu, mem, ntask, pins, alive = pack_instance(seed)
        rng = np.random.default_rng(10_000 + seed)
        cpu_free = rng.uniform(0.0, 1.0, n_nodes)
        mem_free = rng.uniform(0.0, 1.0, n_nodes)
        if alive is not None:
            cpu_free[~alive] = -1.0
            mem_free[~alive] = -1.0
        pre = {k: list(m) for k, (_, _, m) in pins.items()}
        got = _pack_core(n_nodes, jid, cpu, mem, ntask, dict(pre),
                         cpu_free.copy(), mem_free.copy())
        ref = ref_pack_core(n_nodes, jid, cpu, mem, ntask, dict(pre),
                            cpu_free.copy(), mem_free.copy())
        jobs = list(zip(jid.tolist(), cpu.tolist(), mem.tolist(),
                        ntask.tolist()))
        oracle = alloc_reference.pack_core(n_nodes, jobs, dict(pre),
                                           cpu_free.copy(), mem_free.copy(),
                                           {})
        assert _same(got, ref), seed
        assert got == oracle, seed


@pytest.mark.parametrize("block", range(N_PACK // 8))
def test_mcb8_pack_equals_reference(block):
    for seed in range(8 * block, 8 * block + 8):
        n_nodes, jid, cpu, mem, ntask, _, _ = pack_instance(seed)
        jobs = list(zip(jid.tolist(), cpu.tolist(), mem.tolist(),
                        ntask.tolist()))
        got = mcb8_pack(n_nodes, jobs)
        assert _same(got, ref_mcb8_pack(n_nodes, jobs)), seed
        with reference_kernels():
            assert got == ref_mcb8_pack(n_nodes, jobs), seed


# --------------------------------------------------------------------------- #
# the full allocation: yield bisection and low-priority removal               #
# --------------------------------------------------------------------------- #
def full_instance(seed):
    """Job states (seeded specs, virtual times and release times), pinned
    running jobs and an optional ``alive`` mask."""
    rng = np.random.default_rng(50_000 + seed)
    n_nodes = int(rng.integers(2, 20))
    states = []
    for i in range(int(rng.integers(1, 24))):
        spec = JobSpec(
            jid=i, release=float(rng.uniform(0.0, 900.0)),
            proc_time=float(rng.uniform(10.0, 1e4)),
            n_tasks=int(rng.integers(1, 17 if seed % 2 == 0 else 5)),
            cpu_need=_value(rng, CPU_CHOICES),
            mem_req=_value(rng, MEM_CHOICES))
        js = JobState(spec=spec)
        # a few jobs that never ran (vt 0: infinite priority)
        js.vt = 0.0 if rng.random() < 0.1 else float(rng.uniform(0.1, 500.0))
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


def test_full_instances_reach_the_removal_bisection():
    removed = full = dead = 0
    for seed in range(N_FULL):
        states, n_nodes, pinned, alive = full_instance(seed)
        res = mcb8(states, n_nodes, now=1000.0, pinned=pinned, alive=alive)
        removed += bool(res.removed)
        full += res.yld == 1.0
        dead += alive is not None
    assert removed >= 10 and full >= 5 and dead >= 5, (removed, full, dead)


@pytest.mark.parametrize("seed", range(N_FULL))
def test_mcb8_equals_reference(seed):
    states, n_nodes, pinned, alive = full_instance(seed)
    got = mcb8(states, n_nodes, now=1000.0, pinned=pinned, alive=alive)
    ref = ref_mcb8(states, n_nodes, now=1000.0, pinned=pinned, alive=alive)
    with reference_kernels():
        oracle = ref_mcb8(states, n_nodes, now=1000.0, pinned=pinned,
                          alive=alive)
    for other in (ref, oracle):
        assert got.mappings == other.mappings
        assert got.yld == other.yld
        assert got.removed == other.removed
    assert list(got.mappings) == list(ref.mappings)
