"""The port's plain RG-LRU recurrence against the JAX package's.

``linear_recurrence`` on CPU tensors runs the port's sequential loop; it
must agree with the JAX package's Pallas ``rglru_scan`` in interpret mode
(a log-depth prefix combine per time block) and with its oracle
``linear_recurrence_ref`` (an associative scan).  The three round in
different orders, so they agree within the reference's own kernel
tolerance (``tests/test_kernels.py``: atol 1e-5, rtol 1e-4).

``linear_recurrence_chunked_plain`` (the card's chunked route, off every
path) is held to the oracle and the sequential loop within the same
tolerance, with decays near 1, where carries cross many chunks.
"""
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.kernels import ref  # noqa: E402
from repro.kernels.rglru_scan import rglru_scan  # noqa: E402

from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels.rglru_scan import (  # noqa: E402
    CHUNK, CHUNKED_MIN_T, linear_recurrence_chunked_plain,
    linear_recurrence_plain, rglru_route, rglru_scan_cuda)

ATOL, RTOL = 1e-5, 1e-4


def _inputs(seed, B, T, W):
    rng = np.random.default_rng(seed)
    a = (0.9 / (1.0 + np.exp(-rng.standard_normal((B, T, W))))).astype(
        np.float32)
    b = rng.standard_normal((B, T, W)).astype(np.float32)
    h0 = rng.standard_normal((B, W)).astype(np.float32)
    return a, b, h0


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=ATOL,
                               rtol=RTOL)


@pytest.mark.parametrize("B,T,W", [
    (1, 128, 256),
    (2, 256, 512),
    (1, 192, 160),           # non-pow2 both
    (3, 1, 64),              # one decode step
    (1, 1, 2560),            # a RecurrentGemma-2B decode step
])
def test_linear_recurrence_matches_jax(B, T, W):
    a, b, h0 = _inputs(B * T + W, B, T, W)
    h, hT = ops.linear_recurrence(*(torch.from_numpy(x) for x in (a, b, h0)))
    assert h.dtype == torch.float32 and h.shape == (B, T, W)
    assert hT.shape == (B, W)
    ja, jb, jh = (jnp.asarray(x) for x in (a, b, h0))
    h_k, hT_k = rglru_scan(ja, jb, jh, block_t=64, block_w=128,
                           interpret=True)
    h_r, hT_r = ref.linear_recurrence_ref(ja, jb, jh)
    for want_h, want_T in ((h_k, hT_k), (h_r, hT_r)):
        _close(h.numpy(), want_h)
        _close(hT.numpy(), want_T)


def test_linear_recurrence_state_chaining():
    """Two halves with the carried state equal one run, and equal the
    reference's chained Pallas runs."""
    a, b, h0 = _inputs(8, 1, 128, 64)
    ta, tb, th = (torch.from_numpy(x) for x in (a, b, h0))
    h_full, hT_full = linear_recurrence_plain(ta, tb, th)
    h1, s1 = linear_recurrence_plain(ta[:, :64], tb[:, :64], th)
    h2, s2 = linear_recurrence_plain(ta[:, 64:], tb[:, 64:], s1)
    # a sequential loop carries exactly the state it would have reached
    assert torch.equal(torch.cat([h1, h2], 1), h_full)
    assert torch.equal(s2, hT_full)
    ja, jb, jh = (jnp.asarray(x) for x in (a, b, h0))
    _, js1 = rglru_scan(ja[:, :64], jb[:, :64], jh, interpret=True)
    jh2, js2 = rglru_scan(ja[:, 64:], jb[:, 64:], js1, interpret=True)
    _close(h2.numpy(), jh2)
    _close(s2.numpy(), js2)


def test_linear_recurrence_empty_sequence_keeps_the_carry():
    a, b, h0 = _inputs(9, 2, 0, 16)
    h, hT = linear_recurrence_plain(*(torch.from_numpy(x) for x in (a, b, h0)))
    assert h.shape == (2, 0, 16)
    assert torch.equal(hT, torch.from_numpy(h0))


def test_cpu_tensors_take_the_plain_path_without_a_launch():
    a, b, h0 = (torch.from_numpy(x) for x in _inputs(10, 2, 5, 8))
    ops.reset_launches()
    h, hT = ops.linear_recurrence(a, b, h0)
    hp, hTp = linear_recurrence_plain(a, b, h0)
    assert torch.equal(h, hp) and torch.equal(hT, hTp)
    assert ops.launches["rglru_scan"] == 0


def test_cuda_wrapper_refuses_cpu_tensors():
    a, b, h0 = (torch.from_numpy(x) for x in _inputs(11, 1, 4, 8))
    with pytest.raises(ValueError, match="CUDA"):
        rglru_scan_cuda(a, b, h0)


def _slow_inputs(seed, B, T, W):
    """As :func:`_inputs`, with a in [0.99, 1): carries cross chunks."""
    _, b, h0 = _inputs(seed, B, T, W)
    a = np.random.default_rng(seed + 1).uniform(0.99, 1.0, (B, T, W)).astype(
        np.float32)
    return a, b, h0


@pytest.mark.parametrize("B,T,W,slow", [
    (1, 500, 64, False),
    (1, 600, 64, True),       # decays near 1
    (2, 100, 48, True),       # ragged: T % CHUNK != 0
    (1, 20, 16, True),        # T < CHUNK
    (3, 1, 8, False),         # one step
    (2, 96, 130, True),       # whole chunks
])
def test_linear_recurrence_chunked_plain_matches_jax(B, T, W, slow):
    a, b, h0 = (_slow_inputs if slow else _inputs)(T + W, B, T, W)
    h, hT = linear_recurrence_chunked_plain(
        *(torch.from_numpy(x) for x in (a, b, h0)))
    assert h.dtype == torch.float32 and h.shape == (B, T, W)
    assert hT.shape == (B, W)
    h_r, hT_r = ref.linear_recurrence_ref(*(jnp.asarray(x) for x in (a, b,
                                                                     h0)))
    _close(h.numpy(), h_r)
    _close(hT.numpy(), hT_r)
    h_p, hT_p = linear_recurrence_plain(*(torch.from_numpy(x)
                                          for x in (a, b, h0)))
    _close(h.numpy(), h_p.numpy())
    _close(hT.numpy(), hT_p.numpy())


def test_linear_recurrence_chunked_plain_empty_sequence_keeps_the_carry():
    a, b, h0 = _inputs(12, 2, 0, 16)
    h, hT = linear_recurrence_chunked_plain(
        *(torch.from_numpy(x) for x in (a, b, h0)))
    assert h.shape == (2, 0, 16)
    assert torch.equal(hT, torch.from_numpy(h0))


def test_linear_recurrence_chunked_plain_state_chaining():
    """Two calls split off a chunk boundary, the carry passed on, equal one
    oracle run over the whole sequence."""
    a, b, h0 = _slow_inputs(13, 1, 150, 32)
    ta, tb, th = (torch.from_numpy(x) for x in (a, b, h0))
    h1, s1 = linear_recurrence_chunked_plain(ta[:, :70], tb[:, :70], th)
    h2, s2 = linear_recurrence_chunked_plain(ta[:, 70:], tb[:, 70:], s1)
    h_r, hT_r = ref.linear_recurrence_ref(*(jnp.asarray(x) for x in (a, b,
                                                                     h0)))
    _close(torch.cat([h1, h2], 1).numpy(), h_r)
    _close(s2.numpy(), hT_r)


@pytest.mark.parametrize("T,route", [
    (1, "sequential"),                       # decode
    (CHUNKED_MIN_T - 1, "sequential"),
    (CHUNKED_MIN_T, "chunked"),
    (1374, "chunked"),                       # a RecurrentGemma-2B prefill
])
def test_rglru_route(T, route):
    assert CHUNK == 32
    for B, W in ((1, 2560), (4, 2560), (2, 100)):
        assert rglru_route(B, T, W) == route
