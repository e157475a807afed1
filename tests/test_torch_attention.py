"""The port's attention against the JAX package's.

``flash_attention`` and ``flash_decode`` on CPU tensors run the port's
plain versions (the chunked oracles); they must agree with the JAX
package's Pallas kernels in interpret mode and with its jnp oracles, at the
shapes of the reference's own kernel tests plus the RecurrentGemma layout
(MQA, hd 256, a sliding window).  Tolerances are the reference's kernel
tolerances (``tests/test_kernels.py``): fp32 2e-5, the sums taken in
another order; bf16 2e-2, inputs rounded to bf16 identically on both sides
(round to nearest even) and the probabilities cast to bf16 before the PV
product in the oracles but not in the Pallas kernel.

The Hopper kernels run only on the card; here the tests check what
decides them (the routes by types and head dims, the decode split) and
emulate the tensor-core instances' arithmetic in plain PyTorch (bf16
probabilities before P V, an fp32 q as two bf16 parts) against the JAX
package at RecurrentGemma's layout.
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
    _decode_split, attention_instance, attention_route, decode_instance,
    decode_route, flash_attention_cuda, flash_attention_plain,
    flash_decode_cuda, flash_decode_plain)

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


# --------------------------------------------------------------------------
# The Hopper instances' routes, the decode split, and the new numerics
# --------------------------------------------------------------------------
def _empty(shape, dtype):
    return torch.empty(shape, dtype=_TORCH_DT[dtype])


@pytest.mark.parametrize("qdt,kvdt,hd,hdv,route", [
    ("bfloat16", "bfloat16", 64, 64, "wgmma"),
    ("bfloat16", "bfloat16", 128, 128, "wgmma"),
    ("bfloat16", "bfloat16", 256, 256, "wgmma"),
    ("bfloat16", "bfloat16", 256, 128, "wgmma"),
    ("float32", "float32", 256, 256, "cuda_cores"),
    ("float32", "float32", 64, 64, "cuda_cores"),
    ("float32", "bfloat16", 256, 256, "cuda_cores"),
    ("bfloat16", "float32", 128, 128, "cuda_cores"),
    ("bfloat16", "bfloat16", 72, 72, "cuda_cores"),
    ("bfloat16", "bfloat16", 257, 257, "cuda_cores"),
    ("bfloat16", "bfloat16", 128, 72, "cuda_cores"),
])
def test_attention_route_by_types_and_head_dims(qdt, kvdt, hd, hdv, route):
    """bf16 q, k and v with both head dims multiples of 16 up to 256 take
    the tensor-core instance; everything else the CUDA-core one."""
    q = _empty((1, 8, 4, hd), qdt)
    k = _empty((1, 8, 1, hd), kvdt)
    v = _empty((1, 8, 1, hdv), kvdt)
    assert attention_route(q, k, v) == route


@pytest.mark.parametrize("qdt,kvdt,hd,hdv,route", [
    ("bfloat16", "bfloat16", 256, 256, "mma"),
    ("float32", "bfloat16", 256, 256, "mma"),
    ("bfloat16", "bfloat16", 128, 64, "mma"),
    ("bfloat16", "bfloat16", 64, 72, "mma"),
    ("bfloat16", "float32", 256, 256, "cuda_cores"),
    ("float32", "float32", 128, 128, "cuda_cores"),
    ("bfloat16", "bfloat16", 72, 72, "cuda_cores"),
    ("bfloat16", "bfloat16", 64, 60, "cuda_cores"),
])
def test_decode_route_by_types_and_head_dims(qdt, kvdt, hd, hdv, route):
    """A bf16 cache with hd a multiple of 16 and hdv a multiple of 8 takes
    the tensor-core decode instance, whatever q's type; everything else the
    CUDA-core one."""
    q = _empty((2, 4, hd), qdt)
    k = _empty((2, 16, 1, hd), kvdt)
    v = _empty((2, 16, 1, hdv), kvdt)
    assert decode_route(q, k, v) == route


@pytest.mark.parametrize("H,Hkv,hd,hdv,dt,prefill,decode", [
    (32, 8, 128, 128, "bfloat16", "wgmma<2>", "mma<1>"),     # Llama-3-8B
    (10, 1, 256, 256, "bfloat16", "wgmma<4>", "mma<1>"),     # RecurrentGemma
    (15, 5, 64, 64, "bfloat16", "wgmma<1>", "mma<1>"),       # SmolLM-360M
    (32, 1, 128, 192, "bfloat16", "wgmma<3>", "mma<2>"),
    (64, 1, 128, 128, "bfloat16", "wgmma<2>", "mma<4>"),
    (48, 1, 64, 64, "bfloat16", "wgmma<1>", "mma<4>"),
    (32, 8, 128, 128, "float32", "cuda_cores", "cuda_cores"),
])
def test_instances_name_the_template_arguments(H, Hkv, hd, hdv, dt, prefill,
                                               decode):
    """The instance a call launches, as ``ops.routes`` counts it:
    attn_wgmma_kernel<NVP> with NVP = ceil(hdv / 64), and
    decode_mma_kernel<TQ, MT> with MT = ceil(group / 16), 3 and 4 both
    taking the 4-tile instance (csrc/attention.cu)."""
    q = _empty((1, 8, H, hd), dt)
    k = _empty((1, 8, Hkv, hd), dt)
    v = _empty((1, 8, Hkv, hdv), dt)
    assert attention_instance(q, k, v) == prefill
    assert decode_instance(q[:, 0], k, v) == decode


H100_SMS = 132


@pytest.mark.parametrize("S", [1, 31, 32, 33, 100, 1000, 2047, 2048, 4096,
                               65536])
@pytest.mark.parametrize("B,Hkv,G", [(4, 1, 10), (1, 1, 10), (3, 8, 4),
                                     (64, 8, 4), (2, 1, 64), (200, 1, 1)])
def test_decode_split_covers_the_cache_and_fills_the_card(S, B, Hkv, G):
    """Every slot in exactly one split, no split empty, whole 32-key chunks,
    and at least one block for every SM whenever the cache has enough
    chunks for it.  The split depends on the (request, KV head) pairs and
    S, not on G (a block holds the whole group)."""
    groups = B * Hkv
    nsplit, split_keys = _decode_split(groups, S, H100_SMS)
    assert split_keys % 32 == 0 and split_keys >= 32
    assert nsplit * split_keys >= S
    assert (nsplit - 1) * split_keys < S          # no empty split
    chunks = -(-S // 32)
    assert nsplit <= chunks
    assert nsplit * groups >= min(H100_SMS, groups * chunks)
    assert (nsplit, split_keys) == _decode_split(groups, S, H100_SMS)
    H = Hkv * G
    assert H // Hkv == G <= 64


def test_decode_split_at_the_served_shape():
    """RecurrentGemma-2B's decode step: 4 slots x 1 KV head over a 2,048
    ring: 64 splits of 32 keys, 256 blocks, two on each of 132 SMs."""
    nsplit, split_keys = _decode_split(4 * 1, 2048, H100_SMS)
    assert (nsplit, split_keys) == (64, 32)
    assert 4 * nsplit >= H100_SMS


def _tensor_core_prefill(q, k, v, *, causal, window, tile=64):
    """The tensor-core prefill instance's arithmetic in plain PyTorch: bf16
    inputs, fp32 scores, an online softmax over 64-key tiles whose
    unnormalised probabilities are rounded to bf16 before P V, fp32
    accumulation, one division at the end."""
    B, Tq, H, hd = q.shape
    Tk, Hkv = k.shape[1], k.shape[2]
    G = H // Hkv
    scale = 1.0 / np.sqrt(hd)
    qf = q.float()
    kf = k.float().repeat_interleave(G, dim=2)
    vf = v.float().repeat_interleave(G, dim=2)
    pos = torch.arange(Tq)
    lo = (pos - window + 1).clamp(min=0) if window else torch.zeros_like(pos)
    hi = pos + 1 if causal else torch.full_like(pos, Tk)
    m = torch.full((B, H, Tq), -1e30)
    l = torch.zeros((B, H, Tq))
    o = torch.zeros((B, H, Tq, v.shape[-1]))
    for k0 in range(0, Tk, tile):
        keys = torch.arange(k0, min(k0 + tile, Tk))
        s = torch.einsum("bqhd,bkhd->bhqk", qf, kf[:, keys]) * scale
        keep = (keys[None, :] >= lo[:, None]) & (keys[None, :] < hi[:, None])
        s = torch.where(keep, s, torch.tensor(float("-inf")))
        m_new = torch.maximum(m, s.amax(-1))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new[..., None])
        l = l * alpha + p.sum(-1)
        o = o * alpha[..., None] + torch.einsum(
            "bhqk,bkhd->bhqd", p.to(torch.bfloat16).float(), vf[:, keys])
        m = m_new
    out = o / l.clamp(min=1e-30)[..., None]
    return out.permute(0, 2, 1, 3).to(torch.bfloat16)


def test_tensor_core_prefill_numerics_match_jax():
    """P rounded to bf16 before P V is the tensor-core instance's one new
    rounding point; at RecurrentGemma's layout (hd 256, 10 query heads on
    one KV head) with a window that cuts the tiles it stays within the
    bf16 tolerance of the JAX package's kernel and oracle."""
    q, k, v = _qkv(9, (1, 300, 10, 256), (1, 300, 1, 256))
    (jq, tq), (jk, tk), (jv, tv) = (_pair(a, "bfloat16") for a in (q, k, v))
    got = _tensor_core_prefill(tq, tk, tv, causal=True, window=128)
    _close(got, jax_fa(jq, jk, jv, causal=True, window=128, block_q=100,
                       block_k=100, interpret=True), "bfloat16")
    _close(got, ref.flash_attention_ref(jq, jk, jv, causal=True,
                                        window=128), "bfloat16")
    _close(got, flash_attention_plain(tq, tk, tv, causal=True, window=128),
           "bfloat16")


def _tensor_core_decode(q, k_cache, v_cache, lens, *, chunk=32):
    """The tensor-core decode instance's arithmetic in plain PyTorch: q as
    bf16 (an fp32 q as the sum of its bf16 rounding and the bf16 rounding
    of the rest), fp32 scores against the bf16 cache, an online softmax
    over 32-key chunks whose probabilities are rounded to bf16 before P V,
    fp32 accumulation."""
    B, S, Hkv, hd = k_cache.shape
    H = q.shape[1]
    G = H // Hkv
    hi_part = q.to(torch.bfloat16).float()
    qf = hi_part + (q.float() - hi_part).to(torch.bfloat16).float()
    if q.dtype == torch.bfloat16:
        qf = hi_part
    kf = k_cache.float().repeat_interleave(G, dim=2)
    vf = v_cache.float().repeat_interleave(G, dim=2)
    out = torch.empty((B, H, v_cache.shape[-1]))
    for b in range(B):
        n = min(int(lens[b]) + 1, S)
        m = torch.full((H,), -1e30)
        l = torch.zeros(H)
        o = torch.zeros((H, v_cache.shape[-1]))
        for k0 in range(0, n, chunk):
            keys = slice(k0, min(k0 + chunk, n))
            s = torch.einsum("hd,khd->hk", qf[b], kf[b, keys]) / np.sqrt(hd)
            m_new = torch.maximum(m, s.amax(-1))
            alpha = torch.exp(m - m_new)
            p = torch.exp(s - m_new[:, None])
            l = l * alpha + p.sum(-1)
            o = o * alpha[:, None] + torch.einsum(
                "hk,khd->hd", p.to(torch.bfloat16).float(), vf[b, keys])
            m = m_new
        out[b] = o / l.clamp(min=1e-30)[:, None]
    return out.to(q.dtype)


@pytest.mark.parametrize("qdt", ["bfloat16", "float32"])
def test_tensor_core_decode_numerics_match_jax(qdt):
    """The tensor-core decode instance's rounding (q in one or two bf16
    parts, P in bf16) at RecurrentGemma's group of 10 heads, hd 256, with
    lengths inside, at and past the cache, stays within the bf16 tolerance
    of the JAX package's kernel and oracle."""
    q, k, v = _qkv(10, (4, 10, 256), (4, 128, 1, 256))
    jq, tq = _pair(q, qdt)
    (jk, tk), (jv, tv) = (_pair(a, "bfloat16") for a in (k, v))
    lens = [0, 70, 127, 300]
    got = _tensor_core_decode(tq, tk, tv, lens)
    assert got.dtype == _TORCH_DT[qdt]
    jl = jnp.array(lens, jnp.int32)
    _close(got, jax_fd(jq, jk, jv, jl, block_k=32, interpret=True),
           "bfloat16")
    _close(got, ref.flash_decode_ref(jq, jk, jv, jl), "bfloat16")
