"""The port's water-filling matvec against the JAX package's, bit for bit.

The plain PyTorch version (what a CPU tensor runs) must equal the JAX
oracle ``alloc_matvec_ref``, the Pallas kernel in interpret mode and the
sequential numpy CSR matvec exactly, including the empty-width case.  The
CUDA wrappers must refuse CPU tensors, and the device dispatch must send
CPU tensors to the plain versions (the matvec's and the OPT=MIN solve's)
without counting a kernel launch.
"""
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from repro.core.alloc_jax import densify_csr as ref_densify_csr
from repro.core.alloc_kernels import build_csr
from repro.kernels.alloc_matvec import alloc_matvec, alloc_matvec_ref

from repro_torch.kernels import ops
from repro_torch.kernels.alloc_matvec import (alloc_matvec_cuda,
                                              alloc_matvec_plain)
from repro_torch.kernels.maxmin_solve import (maxmin_solve_cuda,
                                              maxmin_solve_plain)


def _x64():
    """Scoped float64 for the JAX side (``jax.enable_x64`` on current jax,
    the experimental context on older releases)."""
    if hasattr(jax, "enable_x64"):
        return jax.enable_x64(True)
    from jax.experimental import enable_x64
    return enable_x64()


def _random_batch(rng, B, N, W):
    """A padded batch of random incidences (zero-need jobs, multiplicity
    above one, empty rows) and random x, plus each lane's CSR."""
    weight = np.zeros((B, N, W))
    x = rng.random((B, W))
    incs = []
    for b in range(B):
        w = int(rng.integers(1, W + 1)) if W else 0
        n = int(rng.integers(1, N + 1))
        cpu = rng.choice([0.0, 0.25, 0.5, 1.0], w)
        mappings = [list(rng.choice(n, int(rng.integers(0, 4)), replace=True))
                    for _ in range(w)]
        inc = build_csr(cpu, mappings, n)
        _, dense = ref_densify_csr(inc, n_nodes=N, width=W)
        weight[b] = dense
        incs.append(inc)
    return weight, x, incs


@pytest.mark.parametrize("shape", [(1, 1, 1), (3, 5, 37), (6, 10, 24),
                                   (4, 16, 64), (2, 7, 0)])
def test_plain_matvec_equals_jax_and_numpy(shape):
    rng = np.random.default_rng(sum(shape))
    weight, x, incs = _random_batch(rng, *shape)
    got = alloc_matvec_plain(torch.from_numpy(weight),
                             torch.from_numpy(x)).numpy()
    with _x64():
        ref = np.asarray(alloc_matvec_ref(weight, x))
        pallas = np.asarray(alloc_matvec(weight, x, interpret=True))
    assert got.dtype == np.float64 and got.shape == shape[:2]
    assert np.array_equal(got, ref)
    assert np.array_equal(got, pallas)
    for b, inc in enumerate(incs):
        seq = inc.matvec(x[b, : inc.width].copy())
        assert np.array_equal(got[b, : inc.n_nodes], seq)
        assert not got[b, inc.n_nodes:].any()


def test_plain_matvec_never_fuses_multiply_add():
    """Operands where a fused multiply-add rounds differently from a
    multiply then an add: the plain version must take the two-rounding
    path, like numpy."""
    rng = np.random.default_rng(5)
    weight = rng.random((64, 1, 2))
    x = rng.random((64, 2))
    got = alloc_matvec_plain(torch.from_numpy(weight),
                             torch.from_numpy(x)).numpy()[:, 0]
    two_roundings = (weight[:, 0, 0] * x[:, 0]) + (weight[:, 0, 1] * x[:, 1])
    assert np.array_equal(got, two_roundings)


def test_ops_dispatch_cpu_runs_plain_without_counting():
    rng = np.random.default_rng(9)
    weight = torch.from_numpy(rng.random((3, 6, 10)))
    x = torch.from_numpy(rng.random((3, 10)))
    present = weight > 0.5
    weight = torch.where(present, weight, torch.zeros_like(weight))
    active = torch.from_numpy(rng.random((3, 10)) < 0.8)
    ops.reset_launches()
    got = ops.alloc_matvec(weight, x)
    assert torch.equal(got, alloc_matvec_plain(weight, x))
    y, rounds = ops.maxmin_solve(present, weight, active)
    y_plain, rounds_plain = maxmin_solve_plain(present, weight, active)
    assert torch.equal(y, y_plain) and torch.equal(rounds, rounds_plain)
    assert ops.launches["alloc_matvec"] == ops.launches["maxmin_solve"] == 0
    assert all(n == 0 for n in ops.launches.values())
    assert not any(ops.routes.values())


def test_cuda_wrappers_refuse_cpu_tensors():
    w = torch.zeros((2, 3, 4), dtype=torch.float64)
    x = torch.zeros((2, 4), dtype=torch.float64)
    with pytest.raises(ValueError, match="CUDA"):
        alloc_matvec_cuda(w, x)
    present = torch.zeros((2, 3, 4), dtype=torch.bool)
    active = torch.ones((2, 4), dtype=torch.bool)
    with pytest.raises(ValueError, match="CUDA"):
        maxmin_solve_cuda(present, w, active)
