"""The port's batched allocator against the JAX and numpy kernels.

On the CPU every per-lane result of ``maxmin_yields_batch`` and of the
solve (``ops.maxmin_solve``, its plain version here) must be bit-equal to
the JAX package's lockstep program (``_maxmin_jit("jnp")`` under float64)
and to the numpy ``maxmin_yields_csr`` on that lane's CSR alone; padding
must never leak into a real lane, and each lane's round count must equal
the numpy loop's and that of the lane solved alone.  One freeze round in
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
from repro_torch.kernels import ops
from repro_torch.kernels.maxmin_solve import (TILE_SMEM_BYTES,
                                              maxmin_round_plain,
                                              maxmin_solve_cuda, solve_route)


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


def _padded(insts, extra_nodes=5, extra_cols=9, extra_lanes=4):
    """The port's and the reference's padded batch of the same instances
    (they must agree), with rows, columns and empty lanes beyond the
    largest instance."""
    incs = [i for i, _ in insts]
    actives = [a for _, a in insts]
    N = max(i.n_nodes for i in incs) + extra_nodes
    W = max(i.width for i in incs) + extra_cols
    B = len(incs) + extra_lanes
    ours = alloc_torch.pad_batch([_carry(i) for i in incs], actives,
                                 n_nodes=N, width=W, n_lanes=B)
    ref = alloc_jax.pad_batch(incs, actives, n_nodes=N, width=W, n_lanes=B)
    for a, b in zip(ours, ref):
        assert np.array_equal(a, b)
    return ours


@pytest.mark.parametrize("seed", [11, 12])
def test_maxmin_batch_matches_jax_and_numpy_with_padding(seed):
    """Co-batched lanes, padded rows/cols and extra empty lanes leave every
    real lane of the solve bit-identical to its solo numpy solve and to the
    JAX lockstep program on the same padded batch; padded lanes run no
    round."""
    rng = np.random.default_rng(seed)
    insts = [random_instance(rng) for _ in range(12)]
    present, weight, active = _padded(insts)
    y, rounds = ops.maxmin_solve(*_tensors(present, weight, active))
    y = y.numpy()
    with _x64():
        y_jax = np.asarray(alloc_jax._maxmin_jit("jnp")(present, weight,
                                                        active))
    assert np.array_equal(y, y_jax)
    assert np.array_equal(y, alloc_torch.maxmin_yields_batch(
        *_tensors(present, weight, active)).numpy())
    for b, (inc, act) in enumerate(insts):
        assert np.array_equal(y[b, : inc.width], maxmin_yields_csr(inc, act))
        assert not y[b, inc.width:].any()
    assert not y[len(insts):].any()
    assert rounds.dtype == torch.int32 and not rounds[len(insts):].any()


def _reference_rounds(present, weight, active):
    """Per lane, the rounds of the numpy loop (``maxmin_yields_csr``'s
    loop, with ``_round_reference`` as its body and numpy's sequential
    matvecs) on that lane alone."""
    out = []
    for b in range(weight.shape[0]):
        p, w, a = present[b:b + 1], weight[b:b + 1], active[b:b + 1]
        y = np.zeros(a.shape)
        frozen = ~a
        n = 0
        for _ in range(int(a.sum()) + 1):
            if frozen.all():
                break
            f_use = np.zeros((1, w.shape[1]))
            u_need = np.zeros((1, w.shape[1]))
            for j in range(w.shape[2]):
                f_use = f_use + w[:, :, j] * np.where(frozen, y, 0.0)[:, None, j]
                u_need = u_need + w[:, :, j] * (~frozen)[:, None, j]
            y, frozen = _round_reference(f_use, u_need, p, frozen, y,
                                         np.ones(1, dtype=bool))
            n += 1
        out.append(n)
    return out


@pytest.mark.parametrize("seed", [21, 22])
def test_solve_rounds_per_lane_match_numpy_and_solo(seed):
    """Each lane's round count equals the numpy loop's on that lane and
    the count of the same lane solved alone: lanes are independent."""
    rng = np.random.default_rng(seed)
    insts = [random_instance(rng) for _ in range(10)]
    present, weight, active = _padded(insts, 2, 3, 2)
    _, rounds = ops.maxmin_solve(*_tensors(present, weight, active))
    assert rounds.tolist() == _reference_rounds(present, weight, active)
    for b in range(present.shape[0]):
        y_solo, r_solo = ops.maxmin_solve(*_tensors(
            present[b:b + 1], weight[b:b + 1], active[b:b + 1]))
        assert int(r_solo[0]) == int(rounds[b])
    assert int(rounds.max()) > 1


def test_maxmin_batch_counts_rounds_and_syncs():
    """One dispatch is one host sync (the yields and the round counts
    together); ``rounds`` gains the slowest lane's count, which is the
    lockstep loop's."""
    rng = np.random.default_rng(13)
    insts = [random_instance(rng) for _ in range(4)]
    present, weight, active = alloc_torch.pad_batch(
        [_carry(i) for i, _ in insts], [a for _, a in insts])
    stats = {}
    y = alloc_torch.maxmin_yields_batch(*_tensors(present, weight, active),
                                        stats=stats)
    y_plain, rounds = ops.maxmin_solve(*_tensors(present, weight, active))
    assert torch.equal(y, y_plain)
    assert stats["host_syncs"] == 1
    assert stats["rounds"] == int(rounds.max())
    assert stats["rounds"] == max(_reference_rounds(present, weight, active))
    assert stats["rounds"] <= int(active.sum(axis=1).max()) + 1


@pytest.mark.parametrize("N, W, route", [
    (128, 32, "shared"), (128, 64, "shared"), (128, 128, "shared"),
    (128, 256, "global"), (16, 1024, "shared"), (1024, 64, "global"),
    (4, 0, "shared")])
def test_solve_route_by_shape(N, W, route):
    """The tile route takes a lane whose weights (odd row stride) and the
    rest fit in 200 KB of shared memory; a larger lane reads its weights
    from global memory."""
    present = torch.zeros((2, N, W), dtype=torch.bool)
    weight = torch.zeros((2, N, W), dtype=torch.float64)
    active = torch.zeros((2, W), dtype=torch.bool)
    assert solve_route(present, weight, active) == route
    words = -(-W // 32)
    tile = 8 * (N * (W | 1) + 2 * W + N) + 4 * (N * words + words)
    assert (tile <= TILE_SMEM_BYTES) == (route == "shared")


def test_solve_cuda_refuses_bad_inputs():
    present = torch.zeros((2, 3, 4), dtype=torch.bool)
    weight = torch.zeros((2, 3, 4), dtype=torch.float64)
    active = torch.zeros((2, 4), dtype=torch.bool)
    with pytest.raises(ValueError, match="CUDA"):
        maxmin_solve_cuda(present, weight, active)
    with pytest.raises(TypeError):
        maxmin_solve_cuda(present, weight.float(), active)
    with pytest.raises(TypeError):
        maxmin_solve_cuda(present.to(torch.uint8), weight, active)
    with pytest.raises(ValueError, match="not \\(B, N, W\\)"):
        maxmin_solve_cuda(present, weight, active[:, :3])
    with pytest.raises(ValueError, match="at most"):
        big = torch.zeros((1, 9000, 1), dtype=torch.float64)
        maxmin_solve_cuda(big.bool(), big, torch.zeros((1, 1), dtype=bool))


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
