"""The port's plain attention against the JAX package's.

``flash_attention`` and ``flash_decode`` on CPU tensors run the port's
plain versions (the chunked oracles); they must agree with the JAX
package's Pallas kernels in interpret mode and with its jnp oracles, at the
shapes of the reference's own kernel tests plus the RecurrentGemma layout
(MQA, hd 256, a sliding window).  Tolerances are the reference's kernel
tolerances (``tests/test_kernels.py``): fp32 2e-5, the sums taken in
another order; bf16 2e-2, inputs rounded to bf16 identically on both sides
(round to nearest even) and the probabilities cast to bf16 before the PV
product in the oracles but not in the Pallas kernel.
"""
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.kernels import ref  # noqa: E402
from repro.kernels.flash_attention import flash_attention as jax_fa  # noqa: E402
from repro.kernels.flash_attention import flash_decode as jax_fd  # noqa: E402

from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels.flash_attention import (  # noqa: E402
    flash_attention_cuda, flash_attention_plain, flash_decode_cuda,
    flash_decode_plain)

TOL = {"float32": 2e-5, "bfloat16": 2e-2}
_JAX_DT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
_TORCH_DT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _pair(x, dtype):
    """The same numpy values as a JAX and a torch array of ``dtype``."""
    return (jnp.asarray(x).astype(_JAX_DT[dtype]),
            torch.from_numpy(x).to(_TORCH_DT[dtype]))


def _np(t):
    return np.asarray(t.float().numpy() if isinstance(t, torch.Tensor)
                      else jnp.asarray(t, jnp.float32))


def _close(got, want, dtype):
    np.testing.assert_allclose(_np(got), _np(want), atol=TOL[dtype],
                               rtol=TOL[dtype])


def _qkv(seed, q_shape, kv_shape):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32)
            for s in (q_shape, kv_shape, kv_shape)]


@pytest.mark.parametrize("B,Tq,Tk,H,Hkv,hd", [
    (1, 128, 128, 4, 4, 64),
    (2, 256, 256, 8, 2, 64),      # GQA
    (1, 64, 512, 4, 1, 128),      # MQA, cross-length
    (2, 384, 384, 6, 3, 32),      # non-pow2 blocks
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_causal_matches_jax(B, Tq, Tk, H, Hkv, hd, dtype):
    q, k, v = _qkv(0, (B, Tq, H, hd), (B, Tk, Hkv, hd))
    (jq, tq), (jk, tk), (jv, tv) = (_pair(a, dtype) for a in (q, k, v))
    off = Tk - Tq
    got = ops.flash_attention(tq, tk, tv, causal=True, q_offset=off)
    assert got.dtype == _TORCH_DT[dtype] and got.shape == (B, Tq, H, hd)
    _close(got, jax_fa(jq, jk, jv, causal=True, q_offset=off, block_q=128,
                       block_k=128, interpret=True), dtype)
    _close(got, ref.flash_attention_ref(jq, jk, jv, causal=True,
                                        q_offset=off), dtype)


@pytest.mark.parametrize("window", [32, 128])
def test_flash_attention_sliding_window_matches_jax(window):
    q, k, v = _qkv(1, (1, 256, 4, 64), (1, 256, 4, 64))
    (jq, tq), (jk, tk), (jv, tv) = (_pair(a, "float32") for a in (q, k, v))
    got = flash_attention_plain(tq, tk, tv, causal=True, window=window)
    _close(got, jax_fa(jq, jk, jv, causal=True, window=window, block_q=64,
                       block_k=64, interpret=True), "float32")
    _close(got, ref.flash_attention_ref(jq, jk, jv, causal=True,
                                        window=window), "float32")


def test_flash_attention_noncausal_matches_jax():
    q, k, v = _qkv(2, (1, 128, 4, 64), (1, 192, 4, 64))
    (jq, tq), (jk, tk), (jv, tv) = (_pair(a, "float32") for a in (q, k, v))
    got = flash_attention_plain(tq, tk, tv, causal=False)
    _close(got, jax_fa(jq, jk, jv, causal=False, block_q=64, block_k=64,
                       interpret=True), "float32")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("T,window", [(96, 32), (100, 16)])
def test_flash_attention_mqa_hd256_window_matches_jax(dtype, T, window):
    """RecurrentGemma's layout: 10 query heads on one KV head, hd 256,
    local attention; T = 100 is not a power of two (the oracle's chunk
    and the TPU kernel's blocks shrink to divide it)."""
    q, k, v = _qkv(3, (1, T, 10, 256), (1, T, 1, 256))
    (jq, tq), (jk, tk), (jv, tv) = (_pair(a, dtype) for a in (q, k, v))
    got = ops.flash_attention(tq, tk, tv, causal=True, window=window)
    _close(got, jax_fa(jq, jk, jv, causal=True, window=window, block_q=32,
                       block_k=32, interpret=True), dtype)
    _close(got, ref.flash_attention_ref(jq, jk, jv, causal=True,
                                        window=window), dtype)


@pytest.mark.parametrize("B,S,H,Hkv,hd", [
    (2, 256, 4, 4, 64),
    (4, 512, 8, 2, 64),
    (1, 128, 4, 1, 128),
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_decode_matches_jax(B, S, H, Hkv, hd, dtype):
    q, k, v = _qkv(4, (B, H, hd), (B, S, Hkv, hd))
    (jq, tq), (jk, tk), (jv, tv) = (_pair(a, dtype) for a in (q, k, v))
    cur = S // 2
    got = ops.flash_decode(tq, tk, tv, cur)
    assert got.dtype == _TORCH_DT[dtype] and got.shape == (B, H, hd)
    _close(got, jax_fd(jq, jk, jv, jnp.int32(cur), block_k=128,
                       interpret=True), dtype)
    _close(got, ref.flash_decode_ref(jq, jk, jv, jnp.int32(cur)), dtype)


@pytest.mark.parametrize("lens", [[10, 100, 255], [0, 255, 256], [300, 5, 700]])
def test_flash_decode_per_request_lengths_matches_jax(lens):
    """Continuous batching: each request has its own length, including
    lengths at and past S (a full ring)."""
    q, k, v = _qkv(5, (3, 4, 64), (3, 256, 4, 64))
    (jq, tq), (jk, tk), (jv, tv) = (_pair(a, "float32") for a in (q, k, v))
    got = flash_decode_plain(tq, tk, tv, torch.tensor(lens))
    jl = jnp.array(lens, jnp.int32)
    _close(got, jax_fd(jq, jk, jv, jl, block_k=64, interpret=True), "float32")
    _close(got, ref.flash_decode_ref(jq, jk, jv, jl), "float32")


def test_flash_decode_fp32_query_bf16_cache_matches_jax():
    """Serving with fp32 parameters and the default bf16 cache: the query
    stays fp32, the cache bf16, the output fp32."""
    q, k, v = _qkv(6, (4, 10, 256), (4, 64, 1, 256))
    jq, tq = _pair(q, "float32")
    (jk, tk), (jv, tv) = (_pair(a, "bfloat16") for a in (k, v))
    lens = [3, 63, 64, 200]
    got = ops.flash_decode(tq, tk, tv, torch.tensor(lens))
    assert got.dtype == torch.float32
    jl = jnp.array(lens, jnp.int32)
    _close(got, jax_fd(jq, jk, jv, jl, block_k=32, interpret=True),
           "bfloat16")
    _close(got, ref.flash_decode_ref(jq, jk, jv, jl), "bfloat16")


def test_cpu_tensors_take_the_plain_path_without_a_launch():
    q, k, v = (torch.from_numpy(a) for a in _qkv(7, (1, 8, 2, 16),
                                                 (1, 8, 1, 16)))
    ops.reset_launches()
    a = ops.flash_attention(q, k, v)
    d = ops.flash_decode(q[:, 0].contiguous(), k, v, 7)
    assert torch.equal(a, flash_attention_plain(q, k, v))
    assert torch.equal(d, flash_decode_plain(q[:, 0], k, v, 7))
    assert ops.launches["flash_attention"] == 0
    assert ops.launches["flash_decode"] == 0


def test_cuda_wrappers_refuse_cpu_tensors():
    q, k, v = (torch.from_numpy(a) for a in _qkv(8, (1, 8, 2, 16),
                                                 (1, 8, 1, 16)))
    with pytest.raises(ValueError, match="CUDA"):
        flash_attention_cuda(q, k, v)
    with pytest.raises(ValueError, match="CUDA"):
        flash_decode_cuda(q[:, 0].contiguous(), k, v, 3)
