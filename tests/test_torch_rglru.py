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

``rglru_gated`` (the layer's gate chain with the recurrence: one launch
of the card's gated route in decode) runs on the CPU and on ``meta`` as
the chain the layer ran inline before, bit for bit, in its gradients and
in what the dry run charges; ``rglru_apply`` through it still agrees with
the JAX package's at the model tests' fp32 tolerance (1e-4), and the
reference's ``rglru_scan`` name and keywords reach the same function.
"""
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.kernels import ref  # noqa: E402
from repro.kernels.rglru_scan import rglru_scan  # noqa: E402

from repro.configs import get_reduced as jax_get_reduced  # noqa: E402
from repro.models import backbone as jbb  # noqa: E402
from repro.models import blocks as jblocks  # noqa: E402

from repro_torch.configs import get_reduced  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import rglru_scan as rglru_mod  # noqa: E402
from repro_torch.kernels.rglru_scan import (  # noqa: E402
    CHUNK, CHUNKED_MIN_T, linear_recurrence_chunked_plain,
    linear_recurrence_plain, rglru_gated_cuda, rglru_gated_plain,
    rglru_route, rglru_scan_cuda)
from repro_torch.launch import cost  # noqa: E402
from repro_torch.models import blocks  # noqa: E402
from repro_torch.models.convert import params_from_reference  # noqa: E402

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


# --------------------------------------------------------------------------- #
# the reference's entry point                                                 #
# --------------------------------------------------------------------------- #
def test_rglru_scan_takes_the_reference_name_and_keywords():
    a, b, h0 = _inputs(21, 2, 40, 96)
    h, hT = rglru_mod.rglru_scan(*(torch.from_numpy(x) for x in (a, b, h0)),
                                 block_t=16, block_w=32, interpret=True)
    ja, jb, jh = (jnp.asarray(x) for x in (a, b, h0))
    h_k, hT_k = rglru_scan(ja, jb, jh, block_t=8, block_w=32, interpret=True)
    _close(h.numpy(), h_k)
    _close(hT.numpy(), hT_k)


# --------------------------------------------------------------------------- #
# the gated route's function: the layer's gate chain, then the recurrence     #
# --------------------------------------------------------------------------- #
def _gated_inputs(seed, B, T, W, dtype):
    """xc and the two block-diagonal products before their biases (B, T,
    W), the biases and lam (W,) in ``dtype``; h0 (B, W) fp32."""
    rng = np.random.default_rng(seed)
    xs = [rng.standard_normal((B, T, W)) * s for s in (1.0, 3.0, 3.0)]
    ws = [rng.standard_normal(W) * s for s in (0.5, 0.5, 2.0)]
    out = [torch.from_numpy(x.astype(np.float32)).to(dtype) for x in xs + ws]
    return out + [torch.from_numpy(
        rng.standard_normal((B, W)).astype(np.float32))]


def _inline_chain(xc, rg_pre, ig_pre, rg_b, ig_b, lam):
    """The chain as ``rglru_apply`` ran it inline before the gated route."""
    rg = torch.sigmoid(rg_pre + rg_b)
    ig = torch.sigmoid(ig_pre + ig_b)
    log_a = -8.0 * torch.logaddexp(lam, torch.zeros_like(lam)) * rg.float()
    a = torch.exp(log_a)
    gated_x = (ig * xc).float()
    beta = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-12))
    return a, beta * gated_x


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("B,T,W", [(4, 1, 2560), (2, 37, 100), (1, 0, 16)])
def test_rglru_gated_plain_is_the_inline_chain(B, T, W, dtype):
    args = _gated_inputs(B * 100 + T + W, B, T, W, dtype)
    want = linear_recurrence_plain(*_inline_chain(*args[:6]), args[6])
    for got in (rglru_gated_plain(*args), ops.rglru_gated(*args)):
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    # hT written over h0, as a serving slot's state
    state = args[6].clone()
    h, hT = ops.rglru_gated(*args[:6], state, state_out=state)
    assert hT is state and torch.equal(state, want[1])
    assert torch.equal(h, want[0])


def test_rglru_gated_gradients_match_the_inline_chain():
    leaves = [t.requires_grad_() for t in _gated_inputs(31, 2, 6, 48,
                                                        torch.float32)]
    seed = torch.from_numpy(np.random.default_rng(32).standard_normal(
        (2, 6, 48)).astype(np.float32))
    grads = []
    for fn in (ops.rglru_gated,
               lambda *a: linear_recurrence_plain(*_inline_chain(*a[:6]),
                                                  a[6])):
        h, hT = fn(*leaves)
        grads.append(torch.autograd.grad((h * seed).sum() + hT.sum(),
                                         leaves))
    for g, w in zip(*grads):
        assert torch.equal(g, w)


def test_rglru_gated_on_meta_charges_what_the_chain_charged():
    """The dry run's count: the chain's operators and the recurrence's
    kernel charge (``rglru_cost``), and the state's copy, as before."""
    shapes = [(4, 1, 2560)] * 3 + [(2560,)] * 3
    args = [torch.empty(s, dtype=torch.bfloat16, device="meta")
            for s in shapes] + [torch.empty((4, 2560), device="meta")]
    state = torch.empty((4, 2560), device="meta")
    traces = []
    for fn in (lambda: ops.rglru_gated(*args, state_out=state),
               lambda: state.copy_(ops.linear_recurrence(
                   *_inline_chain(*args[:6]), args[6])[1])):
        with cost.CostTrace() as tr:
            fn()
        traces.append(tr)
    got, want = traces
    assert (got.flops, got.bytes, got.ops) == (want.flops, want.bytes,
                                               want.ops)
    assert got.kernels == want.kernels and "rglru_scan" in got.kernels


def test_rglru_gated_on_cpu_tensors_never_launches():
    args = _gated_inputs(41, 2, 3, 32, torch.bfloat16)
    ops.reset_launches()
    ops.rglru_gated(*args)
    assert ops.launches["rglru_scan"] == 0
    assert not ops.routes["rglru_scan"]
    with pytest.raises(ValueError, match="CUDA"):
        rglru_gated_cuda(*args)


@pytest.fixture(scope="module")
def reduced_rglru():
    """The reduced RecurrentGemma's first RG-LRU layer in both packages."""
    cfg = jax_get_reduced("recurrentgemma-2b")
    jparams, _ = jbb.init_params(cfg, jax.random.PRNGKey(3))
    tree = jax.tree.map(np.asarray, jparams)
    params = params_from_reference(get_reduced("recurrentgemma-2b"), tree,
                                   device="cpu")
    jp = jax.tree.map(lambda x: x[0], jparams["groups"][0]["mix"])
    return cfg, jp, params["layers"][0]["mix"]


def test_rglru_apply_through_the_gated_op_matches_jax(reduced_rglru):
    """Training (no cache), then a prefill and three decode steps through a
    cache, fp32, against the JAX package's ``rglru_apply`` (1e-4)."""
    cfg, jp, tp = reduced_rglru
    rng = np.random.default_rng(5)

    def close(got, want):
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                                   atol=1e-4, rtol=1e-4)
    x = rng.standard_normal((2, 20, cfg.d_model)).astype(np.float32)
    jy, _ = jblocks.rglru_apply(cfg, jp, jnp.asarray(x), "train", None, 0)
    ty, _ = blocks.rglru_apply(cfg, tp, torch.from_numpy(x), "train", None, 0)
    close(ty, jy)
    jc = jblocks.rglru_cache(cfg, 2, 32, jnp.float32)
    tc = blocks.rglru_cache(cfg, 2, 32, torch.float32, "cpu")
    jy, jc = jblocks.rglru_apply(cfg, jp, jnp.asarray(x), "prefill", jc, 0)
    ty, tc = blocks.rglru_apply(cfg, tp, torch.from_numpy(x), "prefill", tc,
                                0)
    close(ty, jy)
    for step in range(3):
        x1 = rng.standard_normal((2, 1, cfg.d_model)).astype(np.float32)
        jy, jc = jblocks.rglru_apply(cfg, jp, jnp.asarray(x1), "decode", jc,
                                     20 + step)
        ty, tc = blocks.rglru_apply(cfg, tp, torch.from_numpy(x1), "decode",
                                    tc, 20 + step)
        close(ty, jy)
        close(tc["h"], jc["h"])
        close(tc["conv"], jc["conv"])
