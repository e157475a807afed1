"""The port's analysis and oracle modules against the JAX package's, on the
CPU: EQUIPARTITION (``core/equipartition.py``), the pure-Python allocation
oracle (``core/alloc_reference.py``) with the ``reference_kernels`` switch,
and the §4.7 node-usage scatter (``node_usage`` / ``node_usage_batch``,
whose CUDA kernel runs only on the card: here its plain version).

Every comparison is bit-exact, on inputs made with numpy from a seed:

* ``equipartition_schedule`` on Theorem 4's instance for n = 3…40 and on
  seeded random instances, with ``max_stretch`` and ``thm4_instance``;
* each ``alloc_reference`` function against the reference's;
* ``Engine`` runs under ``reference_kernels()`` against the reference's
  oracle run, the port's host hot path and its device path on the CPU,
  for GreedyP/GreedyPM under OPT=MIN/AVG, an MCB8 policy and both
  ``/stretch-per`` passes; the switch takes priority over a backend;
* the node-usage scatter against in-order ``np.add.at`` and against JAX's
  ``segment_sum`` under ``jax.enable_x64(True)`` (not through
  ``repro.core.alloc_jax``, whose import fails under jax 0.9).
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import result_dict

from repro.core import alloc_kernels as ref_kernels
from repro.core import alloc_reference as ref_oracle
from repro.core import equipartition as ref_eq
from repro.core.job import JobSpec as RefSpec
from repro.core.job import NodePool as RefPool
from repro.sched.engine import Engine as RefEngine
from repro.sched.engine import SimParams as RefParams
from repro.workloads.registry import WorkloadSpec as RefWorkload
from repro.workloads.registry import make_trace_ir as ref_trace

from repro_torch.core import alloc_kernels, alloc_reference, equipartition
from repro_torch.core.alloc_torch import (TorchAllocBackend, node_usage,
                                          node_usage_batch)
from repro_torch.core.job import JobSpec, NodePool
from repro_torch.kernels import ops
from repro_torch.kernels.node_usage import node_usage_cuda, node_usage_plain
from repro_torch.sched.engine import Engine, SimParams
from repro_torch.workloads.registry import WorkloadSpec, make_trace_ir


# --------------------------------------------------------------------------- #
# EQUIPARTITION                                                                #
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("n", range(3, 41))
def test_equipartition_thm4_instance_equals_reference(n):
    r, p = equipartition.thm4_instance(n)
    assert (r, p) == ref_eq.thm4_instance(n)
    done = equipartition.equipartition_schedule(r, p)
    assert done == ref_eq.equipartition_schedule(r, p)
    s = equipartition.max_stretch(r, p, done)
    assert s == ref_eq.max_stretch(r, p, done)
    # Theorem 4: every job completes together and the max stretch is n
    assert s == pytest.approx(n, rel=1e-9)


@pytest.mark.parametrize("seed", range(6))
def test_equipartition_random_instances_equal_reference(seed):
    rng = np.random.default_rng(seed)
    n = int(rng.integers(1, 60))
    r = np.sort(rng.exponential(5.0, n).cumsum()) * rng.choice([0.1, 1.0])
    r[rng.random(n) < 0.2] = r[0]               # simultaneous releases
    p = rng.uniform(0.1, 20.0, n)
    done = equipartition.equipartition_schedule(r.tolist(), p.tolist())
    ref = ref_eq.equipartition_schedule(r.tolist(), p.tolist())
    assert done == ref and all(math.isfinite(c) for c in done)
    assert (equipartition.max_stretch(r, p, done)
            == ref_eq.max_stretch(r, p, ref))


def test_equipartition_edges():
    assert equipartition.equipartition_schedule([], []) == []
    assert equipartition.max_stretch([], [], []) == 0.0
    with pytest.raises(AssertionError):
        equipartition.thm4_instance(2)


# --------------------------------------------------------------------------- #
# alloc_reference, function by function                                        #
# --------------------------------------------------------------------------- #
def _instance(seed, n_jobs=None, n_nodes=None):
    rng = np.random.default_rng(seed)
    n = n_nodes or int(rng.integers(2, 12))
    m = n_jobs or int(rng.integers(1, 14))
    rows = [(j, float(rng.uniform(0.0, 10.0)),
             float(rng.choice([0.25, 0.5, 1.0])),
             float(rng.uniform(0.01, 0.4)), int(rng.integers(1, 4)))
            for j in range(m)]
    mappings = [[int(x) for x in rng.integers(0, n, t)]
                for (_, _, _, _, t) in rows]
    port = [JobSpec(jid=j, release=rel, proc_time=100.0, n_tasks=t,
                    cpu_need=c, mem_req=mem) for j, rel, c, mem, t in rows]
    ref = [RefSpec(jid=j, release=rel, proc_time=100.0, n_tasks=t,
                   cpu_need=c, mem_req=mem) for j, rel, c, mem, t in rows]
    return rng, n, port, ref, mappings


@pytest.mark.parametrize("seed", range(8))
def test_yield_oracle_equals_reference(seed):
    _, n, port, ref, mappings = _instance(seed)
    need, lists = alloc_reference.node_tables(port, mappings, n)
    r_need, r_lists = ref_oracle.node_tables(ref, mappings, n)
    assert np.array_equal(need, r_need) and lists == r_lists
    y = alloc_reference.maxmin_yields(port, mappings, n)
    assert np.array_equal(y, ref_oracle.maxmin_yields(ref, mappings, n))
    assert np.array_equal(alloc_reference.avg_yields(port, mappings, n),
                          ref_oracle.avg_yields(ref, mappings, n))


@pytest.mark.parametrize("seed", range(8))
def test_greedy_and_pack_oracle_equal_reference(seed):
    rng, n, port, ref, _ = _instance(seed)
    pool, r_pool = NodePool(n), RefPool(n)
    for node in range(n):
        pool.load[node] = r_pool.load[node] = float(rng.uniform(0, 2))
        pool.mem_free[node] = r_pool.mem_free[node] = float(
            rng.uniform(0.2, 1))
    for s, rs in zip(port, ref):
        got = alloc_reference.greedy_place(pool, s)
        assert got == ref_oracle.greedy_place(r_pool, rs)
        assert np.array_equal(pool.load, r_pool.load)
        assert np.array_equal(pool.mem_free, r_pool.mem_free)
    jobs = [(s.jid, s.cpu_need * 0.6, s.mem_req, s.n_tasks) for s in port]
    pre = {99: [0, 0]}
    free = [np.ones(n) - 0.1, np.ones(n) - 0.2]
    out = alloc_reference.pack_core(n, jobs, pre, free[0].copy(),
                                    free[1].copy(), {})
    assert out == ref_oracle.pack_core(n, jobs, pre, free[0].copy(),
                                       free[1].copy(), {})


class _Job:
    """The job view the stretch passes read: spec, virtual time, flow."""

    def __init__(self, spec, vt, release):
        self.spec, self.vt, self._release = spec, vt, release

    def flow_time(self, now):
        return now - self._release


@pytest.mark.parametrize("seed", range(8))
def test_stretch_oracle_equals_reference(seed):
    rng, n, port, ref, mappings = _instance(seed, n_nodes=8)
    now, period = 5000.0, 600.0
    vts = rng.uniform(0.0, 90.0, len(port))
    jobs = [_Job(s, v, s.release) for s, v in zip(port, vts)]
    r_jobs = [_Job(s, v, s.release) for s, v in zip(ref, vts)]
    maps = {s.jid: m for s, m in zip(port, mappings)}
    ylds = {s.jid: float(y) for s, y in zip(
        port, rng.uniform(0.0, 0.12, len(port)))}
    use = alloc_reference.node_usage(jobs, maps, ylds, n)
    assert np.array_equal(use, ref_oracle.node_usage(r_jobs, maps, ylds, n))
    assert (alloc_reference.improve_max_stretch(jobs, maps, ylds, n, now,
                                                period)
            == ref_oracle.improve_max_stretch(r_jobs, maps, ylds, n, now,
                                              period))
    assert (alloc_reference.improve_avg_stretch(jobs, maps, ylds, n, now,
                                                period)
            == ref_oracle.improve_avg_stretch(r_jobs, maps, ylds, n, now,
                                              period))


# --------------------------------------------------------------------------- #
# the engine under reference_kernels()                                         #
# --------------------------------------------------------------------------- #
ORACLE_POLICIES = ["GreedyP */OPT=MIN", "GreedyP */OPT=AVG",
                   "GreedyPM */OPT=MIN", "GreedyPM */OPT=AVG",
                   "MCB8 */OPT=MIN/MINVT=600", "/stretch-per/OPT=MAX",
                   "/stretch-per/OPT=AVG"]
W = dict(kind="lublin", n_jobs=60, n_nodes=16, seed=3, load=1.2)


@pytest.mark.parametrize("policy", ORACLE_POLICIES)
def test_engine_under_the_oracle_equals_reference_and_hot_paths(policy):
    params = SimParams(n_nodes=16)
    with ref_kernels.reference_kernels():
        ref = RefEngine(ref_trace(RefWorkload(**W)), policy,
                        RefParams(n_nodes=16)).run()
    with alloc_kernels.reference_kernels():
        assert alloc_kernels.reference_kernels_active()
        oracle = Engine(make_trace_ir(WorkloadSpec(**W)), policy,
                        params).run()
    assert not alloc_kernels.reference_kernels_active()
    host = Engine(make_trace_ir(WorkloadSpec(**W)), policy, params).run()
    dev = Engine(make_trace_ir(WorkloadSpec(**W)), policy, params,
                 alloc_backend=TorchAllocBackend(device="cpu")).run()
    assert result_dict(oracle) == result_dict(ref)
    assert result_dict(host) == result_dict(oracle)
    assert result_dict(dev) == result_dict(oracle)
    assert oracle.events > 0 and oracle.max_stretch >= 1.0


class _Refusing:
    def allocate(self, inc, cols, opt="MIN"):
        raise AssertionError("the oracle must run ahead of the backend")


def test_oracle_switch_takes_priority_over_a_backend():
    w = WorkloadSpec(**W)
    with alloc_kernels.reference_kernels():
        r = Engine(make_trace_ir(w), "GreedyP */OPT=MIN",
                   SimParams(n_nodes=16), alloc_backend=_Refusing()).run()
    host = Engine(make_trace_ir(w), "GreedyP */OPT=MIN",
                  SimParams(n_nodes=16)).run()
    assert result_dict(r) == result_dict(host)
    with pytest.raises(AssertionError, match="oracle"):
        Engine(make_trace_ir(w), "GreedyP */OPT=MIN", SimParams(n_nodes=16),
               alloc_backend=_Refusing()).run()


def test_oracle_switch_nests_and_restores():
    assert not alloc_kernels.reference_kernels_active()
    with alloc_kernels.reference_kernels():
        with alloc_kernels.reference_kernels():
            assert alloc_kernels.reference_kernels_active()
        assert alloc_kernels.reference_kernels_active()
    assert not alloc_kernels.reference_kernels_active()
    with pytest.raises(RuntimeError):
        with alloc_kernels.reference_kernels():
            raise RuntimeError("boom")
    assert not alloc_kernels.reference_kernels_active()


# --------------------------------------------------------------------------- #
# node_usage                                                                   #
# --------------------------------------------------------------------------- #
def _usage_lists(seed, B=16, n_nodes=128, K=128 * 32):
    """(B, K) scatter lists at the stretch passes' paper shapes: padding
    sentinels, an empty lane, and repeated nodes with values whose sum
    depends on the order of the adds."""
    rng = np.random.default_rng(seed)
    nodes = rng.integers(0, n_nodes, (B, K))
    vals = rng.random((B, K)) * rng.choice([1e-9, 1.0, 1e9], (B, K))
    lens = rng.integers(0, K + 1, B)
    for b in range(B):
        nodes[b, lens[b]:] = n_nodes            # padding
    nodes[0] = n_nodes                          # an empty lane
    nodes[1, :64] = 7                           # one node, order-dependent
    vals[1, :64] = np.tile([1.0, 1e-16, -1.0, 3e-17], 16)
    return nodes, vals


def _add_at(nodes, vals, n_nodes):
    out = np.zeros((nodes.shape[0], n_nodes))
    for b in range(nodes.shape[0]):
        keep = (nodes[b] >= 0) & (nodes[b] < n_nodes)
        np.add.at(out[b], nodes[b][keep], vals[b][keep])
    return out


@pytest.mark.parametrize("seed", range(3))
def test_node_usage_plain_equals_in_order_add_at(seed):
    nodes, vals = _usage_lists(seed)
    got = node_usage_batch(nodes, vals, 128, device="cpu")
    ref = _add_at(nodes, vals, 128)
    assert got.shape == (16, 128) and np.array_equal(got, ref)
    assert not got[0].any()
    # lane 1's repeated node gives another sum in another order
    fwd = rev = 0.0
    for v in vals[1, :64]:
        fwd += v
    for v in vals[1, 63::-1]:
        rev += v
    assert fwd != rev
    one = node_usage(nodes[2], vals[2], 128, device="cpu")
    assert np.array_equal(one, ref[2])


def test_node_usage_equals_jax_segment_sum():
    nodes, vals = _usage_lists(5, B=4, n_nodes=16, K=500)
    with jax.enable_x64(True):
        seg = jax.vmap(lambda n, v: jax.ops.segment_sum(
            v, n, num_segments=17)[:16])(jnp.asarray(nodes),
                                         jnp.asarray(vals))
        seg = np.asarray(seg)
    assert seg.dtype == np.float64
    assert np.array_equal(node_usage_batch(nodes, vals, 16, device="cpu"),
                          seg)


def test_node_usage_drops_out_of_range_entries():
    nodes = np.array([[0, -1, 3, 4, 99, 3]])
    vals = np.array([[1.0, 2.0, 3.0, 4.0, 5.0, 6.0]])
    got = node_usage_batch(nodes, vals, 4, device="cpu")
    assert got.tolist() == [[1.0, 0.0, 0.0, 9.0]]


def test_node_usage_dispatch_counts_kernel_launches_only():
    ops.reset_launches()
    nodes = torch.tensor([[0, 1, 1]])
    vals = torch.tensor([[1.0, 2.0, 3.0]], dtype=torch.float64)
    assert torch.equal(ops.node_usage(nodes, vals, 2),
                       node_usage_plain(nodes, vals, 2))
    assert ops.launches["node_usage"] == 0      # the plain version ran
    with pytest.raises(ValueError, match="CUDA"):
        node_usage_cuda(nodes, vals, 2)
