"""The 3xTF32 prefill instance's arithmetic, emulated on the CPU, against
the JAX package's ``flash_attention``.

The instance (``attn_tf32x3_kernel`` in ``csrc/attention.cu``) runs only
on the card.  Here its numerics run in plain PyTorch: every fp32 operand
of S = Q K^T and O = P V is split as hi = x rounded to TF32 (to nearest,
ties away from zero, as ``cvt.rna.tf32.f32`` does: integer operations on
the bits) and lo = x - hi, of which the tensor core reads the top 19 bits
(rounding toward zero); a product is the fp32 sum of lo hi, hi lo and hi
hi, each exact in fp32.  The masks are the kernel's row intervals, with a
row that has no key attending to every key with equal weight, as the
reference's finite mask makes it; the softmax is taken in fp32 on exp2
with the scale folded into log2 e.  The reference runs as its own tests
run it on the CPU (its Pallas kernel in interpret mode), at reduced
training shapes, within its fp32 kernel tolerance (2e-5).  The same
emulation with one TF32 product (hi hi) falls outside that tolerance:
that is why the instance takes three.
"""
import math

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.kernels.flash_attention import flash_attention as jax_fa  # noqa: E402

from repro_torch.kernels.flash_attention import (  # noqa: E402
    MAX_HEAD_DIM, attention_instance, tf32x3_tile)

TOL = 2e-5          # the reference's fp32 kernel tolerance
LOG2E = 1.4426950408889634


def _tf32_nearest(x):
    """x rounded to TF32 (10 mantissa bits), ties away from zero."""
    return ((x.view(torch.int32) + 0x1000) & -0x2000).view(torch.float32)


def _tf32_toward_zero(x):
    return (x.view(torch.int32) & -0x2000).view(torch.float32)


def _split(x):
    hi = _tf32_nearest(x)
    return hi, _tf32_toward_zero(x - hi)


def _matmul(a, b, products):
    """a @ b on the TF32 tensor cores: hi hi alone (one product), or lo hi
    + hi lo, then + hi hi (3xTF32); fp32 accumulation."""
    ah, al = _split(a)
    bh, bl = _split(b)
    if products == 1:
        return ah @ bh
    return (al @ bh + ah @ bl) + ah @ bh


def emulated_attention(q, k, v, *, causal=True, window=0, q_offset=0,
                       scale=None, products=3):
    """The 3xTF32 instance's function and arithmetic, q (B, Tq, H, hd),
    k and v (B, Tk, Hkv, hd / hdv), fp32."""
    B, Tq, H, hd = q.shape
    Tk, Hkv = k.shape[1], k.shape[2]
    G = H // Hkv
    scale = scale if scale is not None else 1.0 / math.sqrt(hd)
    qh = q.permute(0, 2, 1, 3)
    kh = k.repeat_interleave(G, dim=2).permute(0, 2, 1, 3)
    vh = v.repeat_interleave(G, dim=2).permute(0, 2, 1, 3)
    s = _matmul(qh, kh.transpose(-1, -2), products)
    pos = q_offset + torch.arange(Tq)
    lo = (pos - window + 1).clamp(min=0) if window > 0 else torch.zeros_like(
        pos)
    hi = (pos + 1).clamp(max=Tk) if causal else torch.full_like(pos, Tk)
    uniform = hi <= lo                       # no key: every key, equally
    lo = torch.where(uniform, 0, lo)
    hi = torch.where(uniform, Tk, hi)
    key = torch.arange(Tk)
    keep = (key[None] >= lo[:, None]) & (key[None] < hi[:, None])
    x = s * torch.tensor(scale * LOG2E, dtype=torch.float32)
    x = torch.where(uniform[:, None], 0.0, x)
    x = torch.where(keep, x, -math.inf)
    p = torch.exp2(x - x.amax(-1, keepdim=True))
    o = _matmul(p, vh, products) / p.sum(-1, keepdim=True)
    return o.permute(0, 2, 1, 3)


# (label, B, Tq, Tk, H, Hkv, hd, hdv, causal, q_offset, scale): the
# training shapes cut in length and heads, their head dims kept
CASES = [
    ("smollm_gqa_15_5", 2, 128, 128, 15, 5, 64, 64, True, 0, None),
    ("mla_192_over_128", 1, 64, 64, 4, 4, 192, 128, True, 0, 192 ** -0.5),
    ("encoder_non_causal", 1, 96, 96, 4, 4, 64, 64, False, 0, None),
    ("cross_tk_ne_tq", 1, 64, 160, 4, 4, 64, 64, False, 0, None),
    ("rows_with_no_key", 1, 64, 64, 4, 2, 64, 64, True, -5, None),
]


def _inputs(seed, B, Tq, Tk, H, Hkv, hd, hdv):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32)
            for s in ((B, Tq, H, hd), (B, Tk, Hkv, hd), (B, Tk, Hkv, hdv))]


def _reference(q, k, v, causal, q_offset, scale):
    return np.asarray(jax_fa(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                             causal=causal, q_offset=q_offset, scale=scale,
                             interpret=True))


def _emulated(q, k, v, causal, q_offset, scale, products):
    return emulated_attention(*(torch.from_numpy(x) for x in (q, k, v)),
                              causal=causal, q_offset=q_offset, scale=scale,
                              products=products).numpy()


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_three_tf32_products_hold_the_fp32_tolerance(case):
    _, B, Tq, Tk, H, Hkv, hd, hdv, causal, off, scale = case
    q, k, v = _inputs(28, B, Tq, Tk, H, Hkv, hd, hdv)
    want = _reference(q, k, v, causal, off, scale)
    got = _emulated(q, k, v, causal, off, scale, products=3)
    np.testing.assert_allclose(got, want, atol=TOL, rtol=TOL)


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_one_tf32_product_misses_it(case):
    _, B, Tq, Tk, H, Hkv, hd, hdv, causal, off, scale = case
    q, k, v = _inputs(28, B, Tq, Tk, H, Hkv, hd, hdv)
    want = _reference(q, k, v, causal, off, scale)
    got = _emulated(q, k, v, causal, off, scale, products=1)
    assert not np.allclose(got, want, atol=TOL, rtol=TOL)


def test_rows_with_no_key_attend_to_every_key_equally():
    """As the reference gives them: its mask is a finite -1e30, so a row
    left with no key has a uniform softmax over all Tk keys."""
    q, k, v = _inputs(5, 1, 16, 40, 2, 1, 8, 8)
    want = _reference(q, k, v, True, -6, None)
    np.testing.assert_allclose(want[0, :6], np.broadcast_to(
        v[0].mean(0), (6, 2, 8)).astype(np.float32), atol=1e-6)
    got = _emulated(q, k, v, True, -6, None, products=3)
    np.testing.assert_allclose(got, want, atol=TOL, rtol=TOL)


@pytest.mark.parametrize("B,Tq,H,Hkv,hd,hdv,instance", [
    (4, 1024, 15, 5, 64, 64, "tf32x3<32,64,128>"),      # SmolLM-360M
    (2, 256, 16, 16, 128, 128, "tf32x3<64,64,32>"),     # Qwen1.5-MoE
    (1, 256, 128, 128, 192, 128, "tf32x3<64,64,64>"),   # DeepSeek-V3 MLA
    (1, 254, 128, 128, 128, 128, "tf32x3<64,64,64>"),   # its MTP block
    (1, 1500, 20, 20, 64, 64, "tf32x3<32,64,128>"),     # Whisper encoder
    (1, 448, 20, 20, 64, 64, "tf32x3<32,64,32>"),       # Whisper decoder
    (1, 512, 64, 8, 128, 128, "tf32x3<64,64,64>"),      # InternVL2-76B
    (1, 256, 10, 1, 256, 256, "tf32x3<128,32,32>"),     # RecurrentGemma-2B
])
def test_training_shapes_take_their_tiles(B, Tq, H, Hkv, hd, hdv, instance):
    """On an H100: 128-row blocks for the large grids at hdv 64, 64-row
    blocks (keys halved between two warps) for grids of 2 blocks an SM,
    32-row ones (keys quartered) below; 64-key tiles where they fit."""
    q = torch.empty((B, Tq, H, hd))
    k = torch.empty((B, Tq, Hkv, hd))
    v = torch.empty((B, Tq, Hkv, hdv))
    assert attention_instance(q, k, v) == instance


@pytest.mark.parametrize("hd", [8, 64, 128, 192, 256])
@pytest.mark.parametrize("hdv", [8, 64, 128, 256])
@pytest.mark.parametrize("Tq", [1, 300, 5000])
def test_every_tile_fits_a_block(hd, hdv, Tq):
    """Q and two K/V stages (pitches hd + 4 and hdv + 4 floats), or the
    key parts' rows at the end, fit the 227 KB a block may use; 128-row
    blocks only where hdv <= 64 (the instances compiled)."""
    for B, H in ((1, 1), (4, 32), (64, 64)):
        rows, keys = tf32x3_tile(B, Tq, H, hd, hdv)
        assert rows in (32, 64, 128) and keys in (32, 64)
        assert rows != 128 or hdv <= 64
        ks = {128: 1, 64: 2, 32: 4}[rows]
        layout = 4 * (rows * (hd + 4) + 2 * keys * (hd + hdv + 8))
        combine = 4 * (ks - 1) * (rows // 16) * 16 * (hdv + 2)
        assert max(layout, combine) <= 232448
        assert hd <= MAX_HEAD_DIM and hdv <= MAX_HEAD_DIM
