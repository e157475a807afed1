"""The port's plain RWKV6 WKV recurrence against the JAX package's.

``ops.wkv6`` on CPU tensors runs the port's sequential loop; it must agree
with the JAX package's Pallas ``wkv6`` in interpret mode (chunks of 32 with
decay rescaling) and with its oracle ``wkv6_ref`` (a ``lax.scan``).  They
sum over dk in different orders, so they agree within the reference's own
kernel tolerance (``tests/test_kernels.py``: atol = rtol = 1e-4).  Inputs
are drawn with numpy, as in the reference's tests: r, k, v, u in
[-0.5, 0.5), w in (0.45, 0.95), s0 in [-0.1, 0.1).

``wkv6_chunked_plain`` (the card's chunked route, off every path) is held
to the oracle and to the sequential loop within the same tolerance, with
decays down to 1e-6, where the reference's own chunked form overflows.
"""
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.kernels import ref  # noqa: E402
from repro.kernels.rwkv6_scan import wkv6 as pallas_wkv6  # noqa: E402

from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels.rwkv6_scan import (CHUNK, CHUNKED_MIN_T,  # noqa: E402
                                            wkv6_chunked_plain, wkv6_cuda,
                                            wkv6_plain, wkv6_route)

TOL = 1e-4


def _inputs(seed, B, T, H, dk, dv):
    rng = np.random.default_rng(seed)

    def uni(shape, scale):
        return (rng.uniform(-1.0, 1.0, shape) * scale).astype(np.float32)
    r, k = uni((B, T, H, dk), 0.5), uni((B, T, H, dk), 0.5)
    v = uni((B, T, H, dv), 0.5)
    w = (0.5 / (1.0 + np.exp(-rng.standard_normal((B, T, H, dk)))) + 0.45
         ).astype(np.float32)
    u = uni((H, dk), 0.5)
    s0 = uni((B, H, dk, dv), 0.1)
    return r, k, v, w, u, s0


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), atol=TOL,
                               rtol=TOL)


def _torch(*arrays):
    return [torch.from_numpy(a) for a in arrays]


@pytest.mark.parametrize("B,T,H,dk,dv", [
    (1, 64, 2, 32, 32),
    (2, 128, 4, 64, 64),
    (1, 96, 2, 64, 64),      # non-pow2 T
    (4, 1, 4, 64, 64),       # one decode step of four slots
    (2, 37, 3, 32, 48),      # ragged: dk != dv, odd T
])
def test_wkv6_matches_jax(B, T, H, dk, dv):
    arrays = _inputs(B * T + H + dk + dv, B, T, H, dk, dv)
    y, sT = ops.wkv6(*_torch(*arrays))
    assert y.dtype == sT.dtype == torch.float32
    assert y.shape == (B, T, H, dv) and sT.shape == (B, H, dk, dv)
    j = [jnp.asarray(a) for a in arrays]
    for want_y, want_s in (ref.wkv6_ref(*j),
                           pallas_wkv6(*j, block_t=32, interpret=True)):
        _close(y, want_y)
        _close(sT, want_s)


def test_wkv6_bf16_inputs_match_jax():
    """bf16 r, k, v (as the model feeds them on the card): both sides widen
    the same bf16 values to fp32, so the fp32 tolerance holds."""
    r, k, v, w, u, s0 = _inputs(5, 2, 64, 4, 64, 64)
    tb = [torch.from_numpy(a).to(torch.bfloat16) for a in (r, k, v)]
    y, sT = ops.wkv6(*tb, *_torch(w, u, s0))
    jb = [jnp.asarray(a, jnp.bfloat16) for a in (r, k, v)]
    jw, ju, js = (jnp.asarray(a) for a in (w, u, s0))
    y_r, s_r = ref.wkv6_ref(*jb, jw, ju, js)
    y_k, s_k = pallas_wkv6(*jb, jw, ju, js, interpret=True)
    for want_y, want_s in ((y_r, s_r), (y_k, s_k)):
        _close(y, want_y)
        _close(sT, want_s)


def test_wkv6_state_chaining():
    """Two halves with the carried state equal one run (exactly: the loop
    carries the state it would have reached), and equal the reference's
    chained Pallas runs."""
    r, k, v, w, u, s0 = _torch(*_inputs(6, 1, 64, 2, 32, 32))
    y_full, s_full = wkv6_plain(r, k, v, w, u, s0)
    h = 32
    y1, s1 = wkv6_plain(r[:, :h], k[:, :h], v[:, :h], w[:, :h], u, s0)
    y2, s2 = wkv6_plain(r[:, h:], k[:, h:], v[:, h:], w[:, h:], u, s1)
    assert torch.equal(torch.cat([y1, y2], 1), y_full)
    assert torch.equal(s2, s_full)
    j = [jnp.asarray(t.numpy()) for t in (r, k, v, w, u, s0)]
    _, js1 = pallas_wkv6(*(x[:, :h] for x in j[:4]), j[4], j[5],
                         interpret=True)
    jy2, js2 = pallas_wkv6(*(x[:, h:] for x in j[:4]), j[4], js1,
                           interpret=True)
    _close(y2, jy2)
    _close(s2, js2)


def test_wkv6_writes_the_state_in_place():
    """``state_out=s0`` updates the given state (a serving slot's view)
    and returns it; the values are those of a fresh run."""
    r, k, v, w, u, s0 = _torch(*_inputs(7, 3, 5, 2, 16, 16))
    y_want, s_want = wkv6_plain(r, k, v, w, u, s0.clone())
    state = s0.clone()
    slot = state[1:2]                      # a contiguous slot view
    y, sT = ops.wkv6(r[1:2], k[1:2], v[1:2], w[1:2], u, slot,
                     state_out=slot)
    assert sT is slot
    assert torch.equal(state[1], s_want[1])
    assert torch.equal(state[0], s0[0]) and torch.equal(state[2], s0[2])
    assert torch.equal(y, y_want[1:2])


def test_wkv6_strong_decay_stays_finite():
    """Decays down to 1e-3 (real checkpoints have channels near 0): the
    sequential recurrence stays finite and equals the oracle."""
    r, k, v, _, u, s0 = _inputs(8, 1, 256, 2, 64, 64)
    w = np.random.default_rng(9).uniform(1e-3, 1.0, r.shape).astype(
        np.float32)
    y, sT = ops.wkv6(*_torch(r, k, v, w, u, s0))
    assert bool(torch.isfinite(y).all() and torch.isfinite(sT).all())
    y_r, s_r = ref.wkv6_ref(*(jnp.asarray(a) for a in (r, k, v, w, u, s0)))
    _close(y, y_r)
    _close(sT, s_r)


def test_cpu_tensors_take_the_plain_path_without_a_launch():
    arrays = _torch(*_inputs(10, 2, 5, 2, 16, 16))
    ops.reset_launches()
    y, sT = ops.wkv6(*arrays)
    yp, sp = wkv6_plain(*arrays)
    assert torch.equal(y, yp) and torch.equal(sT, sp)
    assert ops.launches["wkv6"] == 0


def test_cuda_wrapper_refuses_cpu_tensors():
    arrays = _torch(*_inputs(11, 1, 4, 2, 16, 16))
    with pytest.raises(ValueError, match="CUDA"):
        wkv6_cuda(*arrays)


def _decay_inputs(seed, B, T, H, dk, dv, w_low):
    """As :func:`_inputs`, with w uniform in [w_low, 1)."""
    r, k, v, _, u, s0 = _inputs(seed, B, T, H, dk, dv)
    w = np.random.default_rng(seed + 1).uniform(w_low, 1.0, r.shape).astype(
        np.float32)
    return r, k, v, w, u, s0


@pytest.mark.parametrize("B,T,H,dk,dv,w_low", [
    (1, 500, 2, 64, 64, 1e-3),      # strong decays, T >= 500
    (1, 600, 2, 64, 64, 1e-6),      # decays down to 1e-6
    (2, 100, 3, 32, 48, 0.45),      # ragged: T % 64 and T % 16 != 0, dk != dv
    (1, 37, 2, 16, 16, 0.45),       # T < CHUNK
    (3, 1, 2, 8, 8, 0.9),           # one step
    (1, 128, 2, 64, 64, 0.9),       # whole chunks
])
def test_wkv6_chunked_plain_matches_jax(B, T, H, dk, dv, w_low):
    arrays = _decay_inputs(T + dk + dv, B, T, H, dk, dv, w_low)
    y, sT = wkv6_chunked_plain(*_torch(*arrays))
    assert y.dtype == sT.dtype == torch.float32
    assert y.shape == (B, T, H, dv) and sT.shape == (B, H, dk, dv)
    assert bool(torch.isfinite(y).all() and torch.isfinite(sT).all())
    y_r, s_r = ref.wkv6_ref(*(jnp.asarray(a) for a in arrays))
    _close(y, y_r)
    _close(sT, s_r)
    y_p, s_p = wkv6_plain(*_torch(*arrays))
    _close(y, y_p)
    _close(sT, s_p)


def test_wkv6_chunked_plain_bf16_inputs_match_jax():
    r, k, v, w, u, s0 = _decay_inputs(12, 2, 150, 2, 64, 64, 1e-3)
    tb = [torch.from_numpy(a).to(torch.bfloat16) for a in (r, k, v)]
    y, sT = wkv6_chunked_plain(*tb, *_torch(w, u, s0))
    jb = [jnp.asarray(a, jnp.bfloat16) for a in (r, k, v)]
    y_r, s_r = ref.wkv6_ref(*jb, *(jnp.asarray(a) for a in (w, u, s0)))
    _close(y, y_r)
    _close(sT, s_r)


def test_wkv6_chunked_plain_empty_sequence_keeps_the_state():
    r, k, v, w, u, s0 = _torch(*_inputs(13, 2, 0, 3, 16, 8))
    y, sT = wkv6_chunked_plain(r, k, v, w, u, s0)
    assert y.shape == (2, 0, 3, 8)
    assert torch.equal(sT, s0)


def test_wkv6_chunked_plain_state_chaining():
    """Two calls split off a chunk boundary, the state carried, equal one
    oracle run over the whole sequence."""
    arrays = _decay_inputs(14, 1, 170, 2, 32, 32, 1e-3)
    r, k, v, w, u, s0 = _torch(*arrays)
    h = 100
    y1, s1 = wkv6_chunked_plain(r[:, :h], k[:, :h], v[:, :h], w[:, :h], u,
                                s0)
    y2, s2 = wkv6_chunked_plain(r[:, h:], k[:, h:], v[:, h:], w[:, h:], u,
                                s1)
    y_r, s_r = ref.wkv6_ref(*(jnp.asarray(a) for a in arrays))
    _close(torch.cat([y1, y2], 1), y_r)
    _close(s2, s_r)


def test_wkv6_chunked_plain_writes_the_state_in_place():
    r, k, v, w, u, s0 = _torch(*_inputs(15, 2, 70, 2, 16, 16))
    y_want, s_want = wkv6_chunked_plain(r, k, v, w, u, s0.clone())
    state = s0.clone()
    y, sT = wkv6_chunked_plain(r, k, v, w, u, state, state_out=state)
    assert sT is state
    assert torch.equal(state, s_want) and torch.equal(y, y_want)


@pytest.mark.parametrize("T,dk,dv,route", [
    (1, 64, 64, "sequential"),                   # decode
    (CHUNKED_MIN_T - 1, 64, 64, "sequential"),
    (CHUNKED_MIN_T, 64, 64, "chunked"),
    (1428, 64, 64, "chunked"),                   # an RWKV6-7B prefill
    (1428, 32, 48, "chunked"),
    (1428, 128, 64, "sequential"),               # past the chunked tiles
    (1428, 64, 96, "sequential"),
    (1428, 20, 64, "sequential"),                # rows of partial loads
    (1428, 64, 36, "sequential"),
])
def test_wkv6_route(T, dk, dv, route):
    assert CHUNK == 64
    for B, H in ((1, 64), (4, 64), (2, 3)):
        assert wkv6_route(B, T, H, dk, dv) == route


def test_routes_are_counted_and_reset():
    """The route counters of the two recurrences sit beside the solve's,
    start empty, and :func:`ops.reset_launches` clears them; CPU tensors
    count nothing."""
    assert set(ops.routes) == {"maxmin_solve", "rglru_scan", "wkv6"}
    ops.routes["wkv6"]["chunked"] += 3
    ops.routes["rglru_scan"]["sequential"] += 1
    ops.reset_launches()
    assert all(not c for c in ops.routes.values())
    ops.wkv6(*_torch(*_inputs(16, 1, 80, 2, 16, 16)))
    assert not ops.routes["wkv6"] and ops.launches["wkv6"] == 0
