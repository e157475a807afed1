"""DeepSeek's multi-head latent attention (``repro_torch.models.blocks``
``mla_*``) against the JAX package's on the CPU.

The reduced ``deepseek-v3-671b`` (d_model 64, 4 heads, q and kv latent
ranks 32, qk head dim 16 + 8 rotary, v head dim 16) runs the reference's
``mla_init`` weights, its zero norm weights replaced by seeded noise,
through both packages' ``mla_apply``: the train forward, a prefill into a
cache and decode steps after it at a scalar position and at per-request
(B,) positions, with an fp32 cache and a bf16 one.  The outputs agree
within atol = rtol = 1e-5 in fp32 (2e-3 over a bf16 cache: a softmax
weight rounded to bf16 that falls the other way moves an output by up to
a bf16 step of that weight), and the caches' ``ckv`` and ``kr`` within the
same bounds.  The decode runs the reference un-jitted: under ``jax.jit``
XLA folds the round trip of the weights through bf16 (``w.astype(cache
dtype)`` before the latent product) away, which moves its outputs by up
to 2.5e-3 on these inputs; the port keeps the rounding the reference's
code asks for.  Prefill goes through ``kops.flash_attention``
with qk head dim 24 > v head dim 16 and ``scale=``; its
``autograd.Function`` (the card's path) is checked here with the CUDA
wrapper pointed at the plain version.
"""
import math

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.models import backbone as jbb  # noqa: E402
from repro.models import blocks as jblocks  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402

from repro_torch import configs  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels.flash_attention import (  # noqa: E402
    attention_instance, flash_attention_plain)
from repro_torch.models import backbone, blocks, layers  # noqa: E402

ARCH = "deepseek-v3-671b"
TOL = 1e-5
BF16_TOL = 2e-3
B, T, S = 2, 10, 16
CACHES = {"float32": (jnp.float32, torch.float32, TOL),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, BF16_TOL)}


@pytest.fixture(scope="module")
def mla():
    """(reference config, port config, reference params, port params)."""
    jcfg, tcfg = jconfigs.get_reduced(ARCH), configs.get_reduced(ARCH)
    p, _ = jblocks.mla_init(jax.random.PRNGKey(0), jcfg)
    rng = np.random.default_rng(3)
    p = {k: (np.array(v) if np.asarray(v).any() else
             (0.1 * rng.standard_normal(v.shape)).astype(np.float32))
         for k, v in p.items()}
    return (jcfg, tcfg, {k: jnp.asarray(v) for k, v in p.items()},
            {k: torch.from_numpy(v) for k, v in p.items()})


def _x(seed, t=T):
    return np.random.default_rng(seed).standard_normal(
        (B, t, 64)).astype(np.float32)


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got.float() if isinstance(
        got, torch.Tensor) else got, np.float32),
        np.asarray(want, np.float32), atol=tol, rtol=tol)


def _caches(jcfg, tcfg, name):
    jdt, tdt, _ = CACHES[name]
    return (jblocks.mla_cache(jcfg, B, S, jdt),
            blocks.mla_cache(tcfg, B, S, tdt, "cpu"))


def test_cache_layout_and_the_config():
    cfg = configs.get_reduced(ARCH)
    c = blocks.mla_cache(cfg, B, S, torch.bfloat16, "cpu")
    assert {k: tuple(v.shape) for k, v in c.items()} == \
        {"ckv": (B, S, cfg.kv_lora_rank), "kr": (B, S, cfg.qk_rope_head_dim)}
    assert cfg.qk_nope_head_dim + cfg.qk_rope_head_dim > cfg.v_head_dim
    # MLA latents stay bf16 under an int8 request, as the reference's
    for spec_cache in backbone.init_cache(cfg, 1, 8, dtype=torch.int8,
                                          device="cpu"):
        assert all(t.dtype == torch.bfloat16
                   for t in spec_cache["mix"].values())
    jc = jbb.init_cache(jconfigs.get_reduced(ARCH), 1, 8, dtype=jnp.int8)
    assert jc["groups"][0]["mix"]["ckv"].dtype == jnp.bfloat16


@pytest.mark.parametrize("positions", [(7,), (2, 1)], ids=["T", "B1"])
def test_rope_without_heads_matches_jax(positions):
    x = _x(5, 7)[..., :8]
    pos = np.arange(7) if positions == (7,) else np.array([[3], [9]])
    if positions != (7,):
        x = x[:, :1]
    want = jlayers.rope(jnp.asarray(x), jnp.asarray(pos), 1e4, heads=False)
    got = layers.rope(torch.from_numpy(x), torch.from_numpy(pos), 1e4,
                      heads=False)
    _close(got, want, 1e-6)


def test_train_forward_matches_jax(mla):
    jcfg, tcfg, jp, tp = mla
    x = _x(1)
    want, _ = jax.jit(lambda p, x_: jblocks.mla_apply(
        jcfg, p, x_, "train", None, 0))(jp, jnp.asarray(x))
    got, _ = blocks.mla_apply(tcfg, tp, torch.from_numpy(x), "train", None, 0)
    _close(got, want, TOL)


def _prefill(mla, name):
    jcfg, tcfg, jp, tp = mla
    jc, tc = _caches(jcfg, tcfg, name)
    x = _x(2)
    jy, jc = jax.jit(lambda p, x_, c: jblocks.mla_apply(
        jcfg, p, x_, "prefill", c, 0))(jp, jnp.asarray(x), jc)
    ty, tc = blocks.mla_apply(tcfg, tp, torch.from_numpy(x), "prefill", tc, 0)
    return jc, tc, jy, ty


def _check_caches(jc, tc, tol):
    for k in ("ckv", "kr"):
        assert str(tc[k].dtype) == f"torch.{jc[k].dtype}"
        _close(tc[k], np.asarray(jc[k], np.float32), tol)


@pytest.mark.parametrize("name", list(CACHES))
def test_prefill_matches_jax(mla, name):
    jc, tc, jy, ty = _prefill(mla, name)
    _close(ty, jy, TOL)
    _check_caches(jc, tc, CACHES[name][2])
    assert not tc["ckv"][:, T:].any() and tc["ckv"][:, :T].abs().sum() > 0


@pytest.mark.parametrize("name", list(CACHES))
@pytest.mark.parametrize("batched", [False, True], ids=["scalar", "per_row"])
def test_decode_after_prefill_matches_jax(mla, name, batched):
    """Three decode steps after the prefill: at scalar positions T, T+1,
    T+2, or at per-request positions (the server's decode) that differ by
    row, one of them past the cache's end (written at S - 1)."""
    jcfg, tcfg, jp, tp = mla
    jc, tc, _, _ = _prefill(mla, name)
    tol = CACHES[name][2]
    def jstep(p, x_, c, pos):
        return jblocks.mla_apply(jcfg, p, x_, "decode", c, pos)
    for i in range(3):
        x = _x(10 + i, 1)
        if batched:
            pos = np.array([T + i, S + 2 * i], np.int32)
            jpos, tpos = jnp.asarray(pos), torch.from_numpy(pos.astype(
                np.int64))
        else:
            jpos, tpos = jnp.int32(T + i), T + i
        jy, jc = jstep(jp, jnp.asarray(x), jc, jpos)
        ty, tc = blocks.mla_apply(tcfg, tp, torch.from_numpy(x), "decode",
                                  tc, tpos)
        _close(ty, jy, tol)
        _check_caches(jc, tc, tol)


def test_prefill_calls_the_kernel_with_the_mla_head_dims(monkeypatch, mla):
    """On the card the prefill's one ``flash_attention`` call takes
    q/k (B, T, H, nd + rd), v (B, T, H, vd), contiguous, with ``scale``
    1/sqrt(nd + rd)."""
    _, tcfg, _, tp = mla
    seen = []

    def kernel(q, k, v, **kw):
        assert q.is_contiguous() and k.is_contiguous() and v.is_contiguous()
        seen.append((tuple(q.shape), tuple(k.shape), tuple(v.shape), kw))
        return flash_attention_plain(q, k, v, **kw)
    monkeypatch.setattr(ops, "_on_cuda", lambda t: True)
    monkeypatch.setattr(ops, "flash_attention_cuda", kernel)
    ops.reset_launches()
    blocks.mla_apply(tcfg, tp, torch.from_numpy(_x(2)), "train", None, 0)
    nd, rd, vd = (tcfg.qk_nope_head_dim, tcfg.qk_rope_head_dim,
                  tcfg.v_head_dim)
    H = tcfg.n_heads
    assert seen == [((B, T, H, nd + rd), (B, T, H, nd + rd), (B, T, H, vd),
                     dict(causal=True, window=0, q_offset=0,
                          scale=1.0 / math.sqrt(nd + rd)))]
    assert ops.launches["flash_attention"] == 1
    ops.reset_launches()


def test_the_autograd_function_takes_hd_above_hdv_and_scale(monkeypatch):
    """The card's path of a differentiable call (kernel forward, autograd
    of the plain version backward) at qk head dim 24 > v head dim 16 with
    ``scale``: the same output and gradients as the plain version."""
    monkeypatch.setattr(ops, "_on_cuda", lambda t: True)
    monkeypatch.setattr(ops, "flash_attention_cuda", flash_attention_plain)
    g = torch.Generator().manual_seed(0)
    xs = [torch.randn(s, generator=g) for s in
          ((2, 9, 4, 24), (2, 9, 4, 24), (2, 9, 4, 16))]
    scale = 1.0 / math.sqrt(24)
    outs, grads = [], []
    for fn in (ops.flash_attention, flash_attention_plain):
        leaves = [x.clone().requires_grad_(True) for x in xs]
        y = fn(*leaves, causal=True, scale=scale)
        w = torch.linspace(-1, 1, y.numel()).reshape(y.shape)
        grads.append(torch.autograd.grad((y * w).sum(), leaves))
        outs.append(y.detach())
    assert tuple(outs[0].shape) == (2, 9, 4, 16)
    torch.testing.assert_close(outs[0], outs[1], atol=0, rtol=0)
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, atol=1e-6, rtol=1e-6)
    # hd 24 is no multiple of 16: the reduced MLA takes the CUDA-core
    # instance on the card, DeepSeek-V3's (192 over 128) the tensor cores'
    assert attention_instance(*[x.bfloat16() for x in xs]) == "cuda_cores"
    big = [torch.zeros(1, 1, 128, d, dtype=torch.bfloat16)
           for d in (192, 192, 128)]
    assert attention_instance(*big) == "wgmma<2>"    # DeepSeek-V3's MLA
