"""The port's batched allocator against the JAX and numpy kernels.

On the CPU every per-lane result of ``maxmin_yields_batch`` must be
bit-equal to the JAX package's lockstep program (``_maxmin_jit("jnp")``
under float64) and to the numpy ``maxmin_yields_csr`` on that lane's CSR
alone; padding must never leak into a real lane.  One freeze round in
plain PyTorch must follow the numpy scan's 1e-15 tie rule exactly, and
OPT=AVG must equal ``avg_yields_csr``.  Incidences are carried into the
port with ``csr_from_arrays``.
"""
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from repro.core import alloc_jax
from repro.core.alloc_kernels import avg_yields_csr, build_csr, maxmin_yields_csr

from repro_torch.core import alloc_torch
from repro_torch.core.alloc_torch import (TorchAllocBackend,
                                          TorchBatchedAllocator,
                                          csr_from_arrays)
from repro_torch.kernels.maxmin_round import maxmin_round_plain


def _x64():
    if hasattr(jax, "enable_x64"):
        return jax.enable_x64(True)
    from jax.experimental import enable_x64
    return enable_x64()


# --------------------------------------------------------------------------- #
# fixtures                                                                     #
# --------------------------------------------------------------------------- #
def random_instance(rng, max_width=30, max_nodes=12):
    """A random incidence: varied width, zero-need jobs, dead nodes,
    multiplicities > 1, possibly empty running set."""
    W = int(rng.integers(1, max_width + 1))
    N = int(rng.integers(1, max_nodes + 1))
    run = np.sort(rng.choice(W, int(rng.integers(0, W + 1)), replace=False))
    cpu = rng.choice([0.0, 0.25, 0.5, 1.0], W)
    alive = np.nonzero(rng.random(N) > 0.15)[0]
    if alive.size == 0:
        alive = np.array([0])
    mappings = [[] for _ in range(W)]
    for j in run:
        mappings[j] = list(rng.choice(alive, int(rng.integers(1, 5)),
                                      replace=True))
    inc = build_csr(cpu, mappings, N)
    active = np.zeros(W, dtype=bool)
    active[run] = True
    return inc, active


def _carry(inc):
    """The reference incidence as the port's CSRIncidence."""
    return csr_from_arrays(inc.n_nodes, inc.width, inc.indptr, inc.indices,
                           inc.data)


def _tensors(present, weight, active):
    return (torch.from_numpy(present), torch.from_numpy(weight),
            torch.from_numpy(active))


# --------------------------------------------------------------------------- #
# OPT=MIN                                                                      #
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("seed", [7, 8, 9])
def test_maxmin_single_lane_bit_equal(seed):
    rng = np.random.default_rng(seed)
    for _ in range(10):
        inc, active = random_instance(rng)
        present, weight = alloc_torch.densify_csr(_carry(inc))
        y = alloc_torch.maxmin_yields_batch(
            *_tensors(present[None], weight[None], active[None]))[0].numpy()
        assert np.array_equal(y, maxmin_yields_csr(inc, active))


@pytest.mark.parametrize("seed", [11, 12])
def test_maxmin_batch_matches_jax_and_numpy_with_padding(seed):
    """Co-batched lanes, padded rows/cols and extra empty lanes leave every
    real lane bit-identical to its solo numpy solve and to the JAX
    lockstep program on the same padded batch."""
    rng = np.random.default_rng(seed)
    insts = [random_instance(rng) for _ in range(12)]
    incs = [i for i, _ in insts]
    actives = [a for _, a in insts]
    N = max(i.n_nodes for i in incs)
    W = max(i.width for i in incs)
    present, weight, active = alloc_torch.pad_batch(
        [_carry(i) for i in incs], actives, n_nodes=N + 5, width=W + 9,
        n_lanes=len(incs) + 4)
    ref_p, ref_w, ref_a = alloc_jax.pad_batch(
        incs, actives, n_nodes=N + 5, width=W + 9, n_lanes=len(incs) + 4)
    assert np.array_equal(present, ref_p) and np.array_equal(weight, ref_w)
    assert np.array_equal(active, ref_a)
    y = alloc_torch.maxmin_yields_batch(
        *_tensors(present, weight, active)).numpy()
    with _x64():
        y_jax = np.asarray(alloc_jax._maxmin_jit("jnp")(ref_p, ref_w, ref_a))
    assert np.array_equal(y, y_jax)
    for b, (inc, act) in enumerate(insts):
        assert np.array_equal(y[b, : inc.width], maxmin_yields_csr(inc, act))
        assert not y[b, inc.width:].any()
    assert not y[len(insts):].any()


def test_maxmin_batch_counts_rounds_and_syncs():
    rng = np.random.default_rng(13)
    insts = [random_instance(rng) for _ in range(4)]
    present, weight, active = alloc_torch.pad_batch(
        [_carry(i) for i, _ in insts], [a for _, a in insts])
    stats = {}
    alloc_torch.maxmin_yields_batch(*_tensors(present, weight, active),
                                    stats=stats)
    # one loop test per round plus the final one
    assert stats["host_syncs"] == stats["rounds"] + 1
    assert stats["rounds"] <= int(active.sum(axis=1).max()) + 1


# --------------------------------------------------------------------------- #
# one freeze round: the 1e-15 tie rule                                         #
# --------------------------------------------------------------------------- #
def _round_reference(f_use, u_need, present, frozen, y, live):
    """One freeze round per lane, written as the numpy kernel's loop body
    (``maxmin_yields_csr``) over dense inputs."""
    y, frozen = y.copy(), frozen.copy()
    for b in range(f_use.shape[0]):
        if not live[b]:
            continue
        valid = np.nonzero(u_need[b] > 1e-12)[0]
        levels = np.maximum(0.0, 1.0 - f_use[b, valid]) / u_need[b, valid]
        best, binding = 1.0, []
        for node, level in zip(valid.tolist(), levels.tolist()):
            if level < best - 1e-15:
                best, binding = level, [node]
            elif abs(level - best) <= 1e-15:
                binding.append(node)
        open_ = ~frozen[b]
        if best >= 1.0 - 1e-12:
            best, newly = 1.0, open_.copy()
        else:
            newly = present[b, binding].any(axis=0) & open_
        y[b, open_] = best
        if not newly.any():
            newly = open_
        frozen[b] |= newly
    return y, frozen


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_maxmin_round_tie_rule(seed):
    """Levels planted within and just beyond 1e-15 of each other, in both
    scan orders, against the numpy loop body."""
    rng = np.random.default_rng(seed)
    B, N, W = 16, 9, 12
    base = rng.uniform(0.05, 0.9, (B, 1))
    # offsets around the tolerance: exact ties, 0.4e-15 / 0.9e-15 inside,
    # 1.1e-15 / 3e-15 outside, in random node order
    offs = rng.choice([0.0, 0.4e-15, -0.4e-15, 0.9e-15, -0.9e-15,
                       1.1e-15, -1.1e-15, 3e-15, -3e-15], (B, N))
    u_need = rng.choice([0.0, 0.5, 1.0, 2.0], (B, N))
    # choose f_use so that the level sits at base + offset where u = 1
    f_use = np.where(u_need == 1.0, 1.0 - (base + offs), rng.random((B, N)))
    present = rng.random((B, N, W)) < 0.35
    frozen = rng.random((B, W)) < 0.3
    frozen[0] = True                            # an all-frozen lane
    y = np.where(frozen, rng.random((B, W)), 0.0)
    live = rng.random(B) < 0.85
    live[0] = True
    want_y, want_f = _round_reference(f_use, u_need, present, frozen, y, live)
    got_y, got_f = maxmin_round_plain(
        torch.from_numpy(f_use), torch.from_numpy(u_need),
        torch.from_numpy(present), torch.from_numpy(frozen),
        torch.from_numpy(y), torch.from_numpy(live))
    assert np.array_equal(got_y.numpy(), want_y)
    assert np.array_equal(got_f.numpy(), want_f)


def test_maxmin_round_capped_level_freezes_everything():
    f_use = torch.zeros((1, 3), dtype=torch.float64)
    u_need = torch.tensor([[0.5, 1.0, 0.0]], dtype=torch.float64)
    present = torch.zeros((1, 3, 4), dtype=torch.bool)
    frozen = torch.tensor([[False, True, False, False]])
    y = torch.tensor([[0.0, 0.3, 0.0, 0.0]], dtype=torch.float64)
    live = torch.tensor([True])
    y2, f2 = maxmin_round_plain(f_use, u_need, present, frozen, y, live)
    assert y2.tolist() == [[1.0, 0.3, 1.0, 1.0]]
    assert f2.all()


# --------------------------------------------------------------------------- #
# OPT=AVG and the allocator protocol                                           #
# --------------------------------------------------------------------------- #
def test_avg_backend_bit_equal():
    rng = np.random.default_rng(17)
    backend = TorchAllocBackend(device="cpu")
    n_checked = 0
    for _ in range(20):
        inc, active = random_instance(rng)
        cols = np.nonzero(active)[0].astype(np.int64)
        if not cols.size:
            continue
        got = backend.allocate(_carry(inc), cols, "AVG")
        assert np.array_equal(got, avg_yields_csr(inc, cols))
        n_checked += 1
    assert n_checked >= 10


def test_batched_allocator_mixed_opts():
    """One allocate_many round mixing MIN and AVG requests answers each
    bit-identically to the per-cell numpy kernels."""
    rng = np.random.default_rng(19)
    reqs, refs = [], []
    for k in range(8):
        inc, active = random_instance(rng)
        cols = np.nonzero(active)[0].astype(np.int64)
        opt = "AVG" if (k % 2 and cols.size) else "MIN"
        reqs.append((_carry(inc), cols, opt))
        if opt == "MIN":
            refs.append(maxmin_yields_csr(inc, active)[cols])
        else:
            refs.append(avg_yields_csr(inc, cols))
    alloc = TorchBatchedAllocator(device="cpu")
    outs = alloc.allocate_many(reqs)
    for got, ref in zip(outs, refs):
        assert np.array_equal(got, ref)
    assert alloc.stats["dispatches"] == 2


def test_backend_empty_running_set_and_unknown_opt():
    inc = _carry(build_csr([0.5], [[]], 4))
    backend = TorchAllocBackend(device="cpu")
    for opt in ("MIN", "AVG"):
        assert backend.allocate(inc, np.zeros(0, dtype=np.int64),
                                opt).shape == (0,)
    with pytest.raises(ValueError):
        backend.allocate(inc, np.array([0]), "MAX")


def test_csr_from_arrays_rejects_malformed_input():
    with pytest.raises(ValueError):
        csr_from_arrays(2, 3, [0, 1], [0], [1.0])            # short indptr
    with pytest.raises(ValueError):
        csr_from_arrays(1, 3, [0, 1], [5], [1.0])            # column range
