"""The port's RecurrentGemma serving path against the JAX package's.

The reduced RecurrentGemma config (3 layers: RG-LRU, RG-LRU, local
attention with window 16; d_model 64, vocab 256) runs in both packages on
the CPU with the same weights: the reference's ``init_params`` tree,
carried across by ``repro_torch.models.convert``.  The JAX side runs its
default kernel backend (the jnp oracles); the port runs its plain versions
(CPU tensors).

Tolerances: fp32 parameters and fp32 caches agree to 1e-4 (the same
arithmetic summed in another order, through up to 3 layers and a few
decode steps; the largest gap seen is near 1e-6).  With the default bf16
cache the K/V and conv-state writes round to bf16 on both sides, and an
fp32 value a few ulps apart can round to neighbouring bf16 values, so
logits agree to 2e-3 and greedy tokens exactly.
"""
import dataclasses

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.configs import get_reduced as jax_get_reduced  # noqa: E402
from repro.models import backbone as jbb  # noqa: E402
from repro.models import blocks as jblocks  # noqa: E402
from repro.train.serve import BatchedServer as JaxServer  # noqa: E402
from repro.train.serve import Request as JaxRequest  # noqa: E402
from repro.train.serve import ServeConfig as JaxServeConfig  # noqa: E402

from repro_torch.configs import get_config, get_reduced  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models import backbone, blocks  # noqa: E402
from repro_torch.models.config import layer_plan  # noqa: E402
from repro_torch.models.convert import params_from_reference  # noqa: E402
from repro_torch.train.serve import (BatchedServer, Request,  # noqa: E402
                                     ServeConfig)

ARCH = "recurrentgemma-2b"
FP32_TOL = 1e-4
BF16_CACHE_TOL = 2e-3


@pytest.fixture(scope="module")
def model():
    """(config, JAX params, the port's params) for the reduced config."""
    cfg = jax_get_reduced(ARCH)
    jparams, _ = jbb.init_params(cfg, jax.random.PRNGKey(0))
    tree = jax.tree.map(np.asarray, jparams)
    return cfg, jparams, params_from_reference(get_reduced(ARCH), tree,
                                               device="cpu")


def _tokens(seed, shape, vocab):
    return np.random.default_rng(seed).integers(1, vocab, size=shape).astype(
        np.int32)


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), atol=tol,
                               rtol=tol)


def _t(x):
    return torch.from_numpy(np.asarray(x))


# --------------------------------------------------------------------------- #
# configs and parameters                                                       #
# --------------------------------------------------------------------------- #
def test_configs_match_the_reference():
    asdict = dataclasses.asdict
    assert asdict(get_config(ARCH)) == asdict(jax_get_config(ARCH))
    assert asdict(get_reduced(ARCH)) == asdict(jax_get_reduced(ARCH))
    assert get_config("recurrentgemma_2b").n_layers == 26
    assert get_config("llama3-8b").n_kv_heads == 8   # served by the port
    assert get_config("deepseek-v3-671b").mla        # served by the port
    for name in ("whisper-large-v3", "internvl2-76b"):   # served since
        assert asdict(get_config(name)) == asdict(jax_get_config(name))


def test_full_config_parameter_count_matches_jax():
    assert get_config(ARCH).param_count() == \
        jax_get_config(ARCH).param_count() == 2_825_912_320


def test_port_init_has_the_reference_shapes(model):
    cfg, jparams, converted = model
    gen = torch.Generator().manual_seed(0)
    own = backbone.init_params(get_reduced(ARCH), gen, device="cpu")
    n_ref = sum(int(np.prod(x.shape)) for x in jax.tree.leaves(jparams))
    n_own = sum(t.numel() for t in jax.tree.leaves(own))
    assert n_own == n_ref
    assert jax.tree.map(lambda t: tuple(t.shape), own) == \
        jax.tree.map(lambda t: tuple(t.shape), converted)
    assert len(own["layers"]) == len(layer_plan(cfg)) == 3


def test_encdec_vision_blocks_init_and_int8_layout():
    """Every block kind is ported now: the encoder-decoder and the vision
    stub initialise with the reference's leaves (an unknown block kind
    raises ``ValueError``, as the reference's); and the int8 KV layout."""
    gen = torch.Generator().manual_seed(0)
    for arch in ("whisper_large_v3", "internvl2_76b"):
        cfg = jax_get_reduced(arch)
        jparams, _ = jbb.init_params(cfg, jax.random.PRNGKey(0))
        own = backbone.group_params(cfg, backbone.init_params(
            cfg, gen, device="cpu"))
        assert jax.tree.map(lambda t: tuple(t.shape), own) == \
            jax.tree.map(lambda a: tuple(a.shape), jparams)
    with pytest.raises(ValueError, match="conv"):
        backbone.init_params(dataclasses.replace(
            get_reduced(ARCH), attn_pattern=("conv",)), gen, device="cpu")
    # the int8 KV layout is ported: int8 values with fp32 scales
    c = blocks.attn_cache(get_reduced(ARCH), 1, 8, torch.int8, "cpu")
    assert c["k"].dtype == c["v"].dtype == torch.int8
    assert c["ks"].dtype == c["vs"].dtype == torch.float32


# --------------------------------------------------------------------------- #
# blocks                                                                       #
# --------------------------------------------------------------------------- #
def test_rglru_block_prefill_and_decode_match_jax(model):
    cfg, jparams, params = model
    jp = jax.tree.map(lambda x: x[0], jparams["groups"][0]["mix"])
    tp = params["layers"][0]["mix"]
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 12, cfg.d_model)).astype(np.float32)
    jc = jblocks.rglru_cache(cfg, 2, 32, jnp.float32)
    tc = blocks.rglru_cache(cfg, 2, 32, torch.float32, "cpu")
    jy, jc = jblocks.rglru_apply(cfg, jp, jnp.asarray(x), "prefill", jc, 0)
    ty, tc = blocks.rglru_apply(cfg, tp, _t(x), "prefill", tc, 0)
    _close(ty, jy, FP32_TOL)
    _close(tc["conv"], jc["conv"], FP32_TOL)
    _close(tc["h"], jc["h"], FP32_TOL)
    x1 = rng.standard_normal((2, 1, cfg.d_model)).astype(np.float32)
    jy, jc = jblocks.rglru_apply(cfg, jp, jnp.asarray(x1), "decode", jc, 12)
    ty, tc = blocks.rglru_apply(cfg, tp, _t(x1), "decode", tc, 12)
    _close(ty, jy, FP32_TOL)
    _close(tc["h"], jc["h"], FP32_TOL)


@pytest.mark.parametrize("T", [12, 20])
def test_local_attention_block_prefill_and_decode_match_jax(model, T):
    """Prefill (a prompt shorter and longer than the window of 16), then
    two decode steps at per-request positions; the ring slot the reference
    writes is mirrored."""
    cfg, jparams, params = model
    jp = jax.tree.map(lambda x: x[0], jparams["groups"][1]["mix"])
    tp = params["layers"][2]["mix"]
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, T, cfg.d_model)).astype(np.float32)
    S = min(32, cfg.window)
    jc = jblocks.attn_cache(cfg, 2, S, jnp.float32)
    tc = blocks.attn_cache(cfg, 2, S, torch.float32, "cpu")
    jy, jc = jblocks.attn_apply(cfg, jp, jnp.asarray(x), "prefill", jc, 0,
                                window=cfg.window)
    ty, tc = blocks.attn_apply(cfg, tp, _t(x), "prefill", tc, 0,
                               window=cfg.window)
    _close(ty, jy, FP32_TOL)
    _close(tc["k"], jc["k"], FP32_TOL)
    pos = np.array([T, T - 3], np.int32)
    for _ in range(2):
        x1 = rng.standard_normal((2, 1, cfg.d_model)).astype(np.float32)
        jy, jc = jblocks.attn_apply(cfg, jp, jnp.asarray(x1), "decode", jc,
                                    jnp.asarray(pos), window=cfg.window)
        ty, tc = blocks.attn_apply(cfg, tp, _t(x1), "decode", tc,
                                   _t(pos.astype(np.int64)),
                                   window=cfg.window)
        _close(ty, jy, FP32_TOL)
        _close(tc["k"], jc["k"], FP32_TOL)
        _close(tc["v"], jc["v"], FP32_TOL)
        pos = pos + 1


# --------------------------------------------------------------------------- #
# prefill + decode                                                             #
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("T", [12, 16, 20])
def test_prefill_and_decode_match_jax(model, T):
    """T = 20 is longer than the window (16): prefill keeps the last 16
    keys in slots 0..15 while decode writes position p to slot p % 16, so
    both packages attend to the same wrong token (the reference's ring
    fault, mirrored)."""
    cfg, jparams, params = model
    B, S = 2, 32
    toks = _tokens(3, (B, T + 3), cfg.vocab)
    jc = jbb.init_cache(cfg, B, S, dtype=jnp.float32)
    tc = backbone.init_cache(cfg, B, S, dtype=torch.float32, device="cpu")
    jl, jc = jbb.prefill(cfg, jparams, {"tokens": jnp.asarray(toks[:, :T])},
                         jc)
    tl, tc = backbone.prefill(cfg, params,
                              {"tokens": _t(toks[:, :T]).long()}, tc)
    _close(tl, jl, FP32_TOL)
    for i in range(3):
        jl, jc = jbb.decode_step(cfg, jparams, jnp.asarray(toks[:, T + i]),
                                 jc, jnp.int32(T + i))
        tl, tc = backbone.decode_step(cfg, params,
                                      _t(toks[:, T + i]).long(), tc, T + i)
        _close(tl, jl, FP32_TOL)


@pytest.mark.parametrize("T,faulty", [(12, False), (16, False), (20, True)])
def test_ring_fault_is_mirrored(model, T, faulty):
    """Decode after a prompt of T tokens against the dense forward at the
    same position: equal unless T > window and T % window != 0, where the
    port shows the reference's gap."""
    cfg, jparams, params = model
    toks = _tokens(4, (1, T + 1), cfg.vocab)
    h = backbone.embed_tokens(cfg, params, _t(toks).long())
    hf, _, _ = backbone.forward(cfg, params, h, "train")
    dense = backbone.logits_fn(cfg, params, hf[:, T])
    tc = backbone.init_cache(cfg, 1, 32, dtype=torch.float32, device="cpu")
    _, tc = backbone.prefill(cfg, params, {"tokens": _t(toks[:, :T]).long()},
                             tc)
    dec, _ = backbone.decode_step(cfg, params, _t(toks[:, T]).long(), tc, T)
    gap = float((dec - dense).abs().max())
    jh = jbb.embed_tokens(cfg, jparams, jnp.asarray(toks))
    jhf, _, _ = jbb.forward(cfg, jparams, jh, "train")
    jdense = jbb.logits_fn(cfg, jparams, jhf[:, T])
    jc = jbb.init_cache(cfg, 1, 32, dtype=jnp.float32)
    _, jc = jbb.prefill(cfg, jparams, {"tokens": jnp.asarray(toks[:, :T])},
                        jc)
    jdec, _ = jbb.decode_step(cfg, jparams, jnp.asarray(toks[:, T]), jc,
                              jnp.int32(T))
    jgap = float(jnp.abs(jdec - jdense).max())
    assert abs(gap - jgap) < FP32_TOL
    assert (gap > 1e-2) == faulty, (gap, jgap)


# --------------------------------------------------------------------------- #
# the server                                                                   #
# --------------------------------------------------------------------------- #
def _requests(cls, cfg, lens, max_new):
    return [cls(rid=i, prompt=_tokens(10 + i, (n,), cfg.vocab),
                max_new=max_new) for i, n in enumerate(lens)]


def test_batched_server_matches_jax_greedy(model):
    """Five requests through two slots (slots are reused, the queue is
    FCFS), fp32 parameters and the default bf16 cache, one prompt longer
    than the window: identical greedy tokens, request for request."""
    cfg, jparams, params = model
    lens, max_new = [5, 20, 9, 13, 3], 6
    jsrv = JaxServer(cfg, jparams, JaxServeConfig(slots=2, cache_len=32))
    tsrv = BatchedServer(cfg, params, ServeConfig(slots=2, cache_len=32),
                         device="cpu")
    jreqs = _requests(JaxRequest, cfg, lens, max_new)
    treqs = _requests(Request, cfg, lens, max_new)
    for jr, tr in zip(jreqs, treqs):
        jsrv.submit(jr)
        tsrv.submit(tr)
    jsrv.run_until_drained()
    steps = tsrv.run_until_drained()
    assert 0 < steps < 10_000
    assert all(r.done for r in treqs)
    assert [r.out for r in treqs] == [r.out for r in jreqs]
    assert all(len(r.out) == max_new for r in treqs)


def test_batched_server_decode_logits_match_jax(model):
    """The first decode step of a full batch, bf16 cache: logits agree."""
    cfg, jparams, params = model
    jsrv = JaxServer(cfg, jparams, JaxServeConfig(slots=2, cache_len=32))
    tsrv = BatchedServer(cfg, params, ServeConfig(slots=2, cache_len=32),
                         device="cpu")
    for srv, cls in ((jsrv, JaxRequest), (tsrv, Request)):
        for r in _requests(cls, cfg, [7, 18], 4):
            srv.submit(r)
        srv._admit()
    np.testing.assert_array_equal(tsrv.last_tok, jsrv.last_tok)
    jl, _ = jsrv._decode(jnp.asarray(jsrv.last_tok), jsrv.caches,
                         jnp.asarray(jsrv.pos))
    tl, _ = tsrv._decode_impl(_t(tsrv.last_tok.astype(np.int64)),
                              tsrv.caches, _t(tsrv.pos.astype(np.int64)))
    _close(tl, jl, BF16_CACHE_TOL)


def test_batched_server_sampling_is_seeded(model):
    cfg, _, params = model
    outs = []
    for _ in range(2):
        srv = BatchedServer(cfg, params, ServeConfig(
            slots=2, cache_len=32, temperature=1.0, seed=5), device="cpu")
        reqs = _requests(Request, cfg, [4, 6, 8], 5)
        for r in reqs:
            srv.submit(r)
        srv.run_until_drained()
        outs.append([r.out for r in reqs])
    assert outs[0] == outs[1]
    assert all(len(o) == 5 for o in outs[0])


def test_serving_on_cpu_launches_no_kernel(model):
    cfg, _, params = model
    ops.reset_launches()
    srv = BatchedServer(cfg, params, ServeConfig(slots=1, cache_len=32),
                        device="cpu")
    srv.submit(Request(rid=0, prompt=_tokens(0, (6,), cfg.vocab), max_new=3))
    srv.run_until_drained()
    assert ops.launches["flash_attention"] == ops.launches["flash_decode"] \
        == ops.launches["rglru_scan"] == 0
