"""The port's RWKV6 serving path against the JAX package's.

The reduced RWKV6 config (2 layers, d_model 64, 4 heads of 16, d_ff 128,
vocab 256) runs in both packages on the CPU with the same weights: the
reference's ``init_params`` tree, carried across by
``repro_torch.models.convert``.  The JAX side runs its default kernel
backend (the jnp oracles); the port runs its plain versions (CPU tensors).

Tolerances, as in ``tests/test_torch_model.py``: fp32 parameters and fp32
caches agree to 1e-4 (the same arithmetic summed in another order); with
the default bf16 cache the token-shift inputs round to bf16 on both sides,
and an fp32 value a few ulps apart can round to neighbouring bf16 values,
so logits agree to 2e-3 and greedy tokens exactly.
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
from repro_torch.launch.serve import main as serve_main  # noqa: E402
from repro_torch.models import backbone, blocks  # noqa: E402
from repro_torch.models.config import layer_groups, layer_plan  # noqa: E402
from repro_torch.models.convert import params_from_reference  # noqa: E402
from repro_torch.train.serve import (BatchedServer, Request,  # noqa: E402
                                     ServeConfig)

ARCH = "rwkv6-7b"
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


def _n(params):
    return sum(int(np.prod(x.shape)) for x in jax.tree.leaves(params))


# --------------------------------------------------------------------------- #
# configs and parameters                                                       #
# --------------------------------------------------------------------------- #
def test_configs_match_the_reference():
    asdict = dataclasses.asdict
    assert asdict(get_config(ARCH)) == asdict(jax_get_config(ARCH))
    assert asdict(get_reduced(ARCH)) == asdict(jax_get_reduced(ARCH))
    cfg = get_config("rwkv6_7b")
    assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.rwkv_head_dim,
            cfg.d_ff, cfg.vocab) == (32, 4096, 64, 64, 14336, 65536)
    red = get_reduced(ARCH)
    assert (red.n_layers, red.d_model, red.n_heads, red.rwkv_head_dim,
            red.vocab) == (2, 64, 4, 16, 256)


def _count_gap(cfg):
    """What ``param_count`` over-counts for an RWKV6 stack: per layer the
    channel mix (3 D F counted, 2 D F + D^2 allocated) and the small
    matrices and vectors (386 D counted, 461 D allocated: the loras, the
    decay loras, 13 vectors), less the final norm it leaves out."""
    D, F = cfg.d_model, cfg.d_ff
    return cfg.n_layers * (D * F - D * D - 75 * D) - D


def test_param_count_fault_is_mirrored(model):
    """The port keeps the reference's ``param_count`` formula, so both
    count 8,908,963,840 parameters for RWKV6-7B, while the reference
    allocates 7,576,621,056 (shapes only, nothing allocated here) and the
    port allocates what the reference does (reduced config)."""
    full = get_config(ARCH)
    assert full.param_count() == jax_get_config(ARCH).param_count() \
        == 8_908_963_840
    allocated_full = _n(jbb.param_shapes(jax_get_config(ARCH)))
    assert allocated_full == 7_576_621_056
    assert full.param_count() - allocated_full == _count_gap(full)
    cfg, jparams, _ = model
    own = backbone.init_params(get_reduced(ARCH), torch.Generator()
                               .manual_seed(0), device="cpu")
    allocated = sum(t.numel() for t in jax.tree.leaves(own))
    assert allocated == _n(jparams)
    assert get_reduced(ARCH).param_count() == cfg.param_count() \
        == allocated + _count_gap(cfg)


def test_port_init_has_the_reference_shapes(model):
    """An RWKV6 layer owns its channel mix (no ``mlp`` entry); the
    converter unstacks the reference's single group of 2 layers into the
    port's per-layer dicts, with the port's own init's shapes."""
    cfg, jparams, converted = model
    assert [(s.kind, n) for s, n in layer_groups(cfg)] == [("rwkv6", 2)]
    own = backbone.init_params(get_reduced(ARCH),
                               torch.Generator().manual_seed(0), device="cpu")
    assert jax.tree.map(lambda t: tuple(t.shape), own) == \
        jax.tree.map(lambda t: tuple(t.shape), converted)
    assert len(own["layers"]) == len(layer_plan(cfg)) == 2
    assert all(set(layer) == {"mix"} for layer in own["layers"])
    ref_mix = jparams["groups"][0]["mix"]
    for i, layer in enumerate(converted["layers"]):
        for name, t in layer["mix"].items():
            np.testing.assert_array_equal(t.numpy(),
                                          np.asarray(ref_mix[name][i]))
    assert own["layers"][0]["mix"]["lora_b"].shape == (5, 32, cfg.d_model)
    assert own["layers"][0]["mix"]["u"].shape == (cfg.n_heads,
                                                  cfg.rwkv_head_dim)


# --------------------------------------------------------------------------- #
# the block                                                                    #
# --------------------------------------------------------------------------- #
def test_rwkv6_block_prefill_and_decode_match_jax(model):
    """Prefill from a carried cache (nonzero token-shift inputs and state),
    then two decode steps: outputs and the caches x_tm, x_cm, s agree; the
    port writes the cache it was given in place."""
    cfg, jparams, params = model
    jp = jax.tree.map(lambda x: x[1], jparams["groups"][0]["mix"])
    tp = params["layers"][1]["mix"]
    rng = np.random.default_rng(1)
    B, D, H, dk = 2, cfg.d_model, cfg.n_heads, cfg.rwkv_head_dim
    start = {"x_tm": rng.standard_normal((B, D)).astype(np.float32),
             "x_cm": rng.standard_normal((B, D)).astype(np.float32),
             "s": (0.1 * rng.standard_normal((B, H, dk, dk))).astype(
                 np.float32)}
    jc = {k: jnp.asarray(v) for k, v in start.items()}
    tc = blocks.rwkv6_cache(cfg, B, 32, torch.float32, "cpu")
    for k, v in start.items():
        tc[k].copy_(_t(v))
    held = {k: v for k, v in tc.items()}
    x = rng.standard_normal((B, 12, D)).astype(np.float32)
    jy, jc = jblocks.rwkv6_apply(cfg, jp, jnp.asarray(x), "prefill", jc, 0)
    ty, tc = blocks.rwkv6_apply(cfg, tp, _t(x), "prefill", tc, 0)
    assert all(tc[k] is held[k] for k in held)
    _close(ty, jy, FP32_TOL)
    for name in ("x_tm", "x_cm", "s"):
        _close(tc[name], jc[name], FP32_TOL)
    for step in range(2):
        x1 = rng.standard_normal((B, 1, D)).astype(np.float32)
        jy, jc = jblocks.rwkv6_apply(cfg, jp, jnp.asarray(x1), "decode", jc,
                                     12 + step)
        ty, tc = blocks.rwkv6_apply(cfg, tp, _t(x1), "decode", tc,
                                    12 + step)
        _close(ty, jy, FP32_TOL)
        for name in ("x_tm", "x_cm", "s"):
            _close(tc[name], jc[name], FP32_TOL)


def test_rwkv6_block_without_cache_matches_jax(model):
    """The train-mode forward (zero token shift and state, no cache)."""
    cfg, jparams, params = model
    jp = jax.tree.map(lambda x: x[0], jparams["groups"][0]["mix"])
    x = np.random.default_rng(2).standard_normal(
        (2, 9, cfg.d_model)).astype(np.float32)
    jy, _ = jblocks.rwkv6_apply(cfg, jp, jnp.asarray(x), "train", None, 0)
    ty, _ = blocks.rwkv6_apply(cfg, params["layers"][0]["mix"], _t(x),
                               "train", None, 0)
    _close(ty, jy, FP32_TOL)


def test_rwkv6_cache_dtypes():
    """The token-shift inputs in the cache dtype, the state in fp32."""
    cfg = get_reduced(ARCH)
    c = backbone.init_cache(cfg, 3, 16, device="cpu")
    assert len(c) == 2
    mix = c[0]["mix"]
    assert mix["x_tm"].dtype == mix["x_cm"].dtype == torch.bfloat16
    assert mix["x_tm"].shape == (3, cfg.d_model)
    assert mix["s"].dtype == torch.float32
    assert mix["s"].shape == (3, cfg.n_heads, cfg.rwkv_head_dim,
                              cfg.rwkv_head_dim)


@pytest.mark.parametrize("arch", ["rwkv6-7b", "recurrentgemma-2b"])
def test_int8_cache_request_keeps_recurrent_caches_bf16(arch):
    """The int8 layout exists for attention KV only: under an int8 request
    the recurrent caches (x_tm, x_cm, conv) stay bf16 and the states (s,
    h) fp32, layer by layer as the reference's ``_block_cache`` gives
    them, and attention layers (RecurrentGemma's local attention) get the
    quantized layout, int8 k / v with fp32 scales, as there too."""
    jcfg, cfg = jax_get_reduced(arch), get_reduced(arch)
    jc = jbb.init_cache(jcfg, 2, 16, dtype=jnp.int8)
    want = [{k: str(np.dtype(x.dtype)) for k, x in g["mix"].items()}
            for g in jc["groups"]]
    recurrent = {"rwkv6": ("x_tm", "x_cm", "s"), "rglru": ("conv", "h")}
    checked = 0
    for (spec, _), dtypes in zip(layer_groups(cfg), want):
        got = backbone._block_cache(cfg, spec, 2, 16, torch.int8, "cpu")
        if spec.kind not in recurrent:
            assert dtypes["k"] == "int8"
            assert sorted(got) == sorted(dtypes) == ["k", "ks", "v", "vs"]
        else:
            assert sorted(got) == sorted(dtypes) == sorted(
                recurrent[spec.kind])
            checked += 1
        for key, t in got.items():
            assert str(t.dtype).removeprefix("torch.") == dtypes[key], key
    assert checked > 0
    caches = backbone.init_cache(cfg, 2, 16, dtype=torch.int8, device="cpu")
    assert len(caches) == len(layer_plan(cfg))
    for c, spec in zip(caches, layer_plan(cfg)):
        if spec.kind in recurrent:
            key = "x_tm" if spec.kind == "rwkv6" else "conv"
            assert c["mix"][key].dtype == torch.bfloat16
        else:
            assert c["mix"]["k"].dtype == torch.int8


def test_int8_cache_request_decodes_as_the_bf16_cache(model):
    """Reduced RWKV6-7B with an int8 cache request: prefill and decode
    logits equal those of the bf16-cache run exactly (the same caches)."""
    cfg, _, params = model
    toks = _t(_tokens(30, (2, 12), cfg.vocab)).long()
    out = {}
    for dtype in (torch.int8, torch.bfloat16):
        tc = backbone.init_cache(cfg, 2, 32, dtype=dtype, device="cpu")
        logits = []
        lg, tc = backbone.prefill(cfg, params, {"tokens": toks[:, :9]}, tc)
        logits.append(lg)
        for i in range(9, 12):
            lg, tc = backbone.decode_step(cfg, params, toks[:, i], tc, i)
            logits.append(lg)
        out[dtype] = logits
    for a, b in zip(out[torch.int8], out[torch.bfloat16]):
        assert torch.equal(a, b)


# --------------------------------------------------------------------------- #
# prefill + decode                                                             #
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("cache_dtype,tol", [("float32", FP32_TOL),
                                             ("bfloat16", BF16_CACHE_TOL)])
def test_prefill_and_decode_match_jax(model, cache_dtype, tol):
    cfg, jparams, params = model
    B, S, T = 2, 32, 11
    toks = _tokens(3, (B, T + 3), cfg.vocab)
    jc = jbb.init_cache(cfg, B, S, dtype=getattr(jnp, cache_dtype))
    tc = backbone.init_cache(cfg, B, S, dtype=getattr(torch, cache_dtype),
                             device="cpu")
    jl, jc = jbb.prefill(cfg, jparams, {"tokens": jnp.asarray(toks[:, :T])},
                         jc)
    tl, tc = backbone.prefill(cfg, params,
                              {"tokens": _t(toks[:, :T]).long()}, tc)
    _close(tl, jl, tol)
    for i in range(3):
        jl, jc = jbb.decode_step(cfg, jparams, jnp.asarray(toks[:, T + i]),
                                 jc, jnp.int32(T + i))
        tl, tc = backbone.decode_step(cfg, params,
                                      _t(toks[:, T + i]).long(), tc, T + i)
        _close(tl, jl, tol)


def test_decode_continues_the_dense_forward(model):
    """With fp32 caches, prefill then decode equals the forward over the
    whole sequence (a recurrence has no window): the port's caches carry
    exactly what the next token needs."""
    cfg, _, params = model
    toks = _t(_tokens(4, (1, 10), cfg.vocab)).long()
    hf, _, _ = backbone.forward(cfg, params,
                             backbone.embed_tokens(cfg, params, toks), "train")
    dense = backbone.logits_fn(cfg, params, hf[:, 9])
    tc = backbone.init_cache(cfg, 1, 16, dtype=torch.float32, device="cpu")
    _, tc = backbone.prefill(cfg, params, {"tokens": toks[:, :9]}, tc)
    dec, _ = backbone.decode_step(cfg, params, toks[:, 9], tc, 9)
    _close(dec, dense, FP32_TOL)


def test_slot_state_leak_is_mirrored(model):
    """A prefill into a cache that holds an earlier request's state starts
    from that state (the reference's serving fault, ROADMAP.md): the
    logits move away from a fresh prefill's, by the same amount on both
    sides."""
    cfg, jparams, params = model
    a, b = _tokens(20, (1, 7), cfg.vocab), _tokens(21, (1, 9), cfg.vocab)
    fresh, _ = backbone.prefill(cfg, params, {"tokens": _t(a).long()},
                                backbone.init_cache(cfg, 1, 32, device="cpu"))
    tc = backbone.init_cache(cfg, 1, 32, device="cpu")
    _, tc = backbone.prefill(cfg, params, {"tokens": _t(b).long()}, tc)
    reused, _ = backbone.prefill(cfg, params, {"tokens": _t(a).long()}, tc)
    jc = jbb.init_cache(cfg, 1, 32)
    _, jc = jbb.prefill(cfg, jparams, {"tokens": jnp.asarray(b)}, jc)
    jreused, _ = jbb.prefill(cfg, jparams, {"tokens": jnp.asarray(a)}, jc)
    _close(reused, jreused, BF16_CACHE_TOL)
    gap = float((reused - fresh).abs().max())
    jgap = float(jnp.abs(jreused - jnp.asarray(fresh.numpy())).max())
    assert gap > 1e-2 and abs(gap - jgap) < BF16_CACHE_TOL, (gap, jgap)


# --------------------------------------------------------------------------- #
# the server                                                                   #
# --------------------------------------------------------------------------- #
def _requests(cls, cfg, lens, max_new):
    return [cls(rid=i, prompt=_tokens(10 + i, (n,), cfg.vocab),
                max_new=max_new) for i, n in enumerate(lens)]


def test_batched_server_matches_jax_greedy(model):
    """Five requests through two slots (slots are reused, so the mirrored
    state leak is in both runs), fp32 parameters and the default bf16
    cache: identical greedy tokens, request for request."""
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
    assert all(r.done and len(r.out) == max_new for r in treqs)
    assert [r.out for r in treqs] == [r.out for r in jreqs]


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


def test_serving_on_cpu_launches_no_kernel(model):
    cfg, _, params = model
    ops.reset_launches()
    srv = BatchedServer(cfg, params, ServeConfig(slots=1, cache_len=32),
                        device="cpu")
    srv.submit(Request(rid=0, prompt=_tokens(0, (6,), cfg.vocab), max_new=3))
    srv.run_until_drained()
    assert all(n == 0 for n in ops.launches.values())


def test_serving_launcher_runs_rwkv6_on_the_cpu(capsys):
    assert serve_main(["--arch", "rwkv6-7b", "--reduced", "--device", "cpu",
                       "--requests", "3", "--slots", "2", "--cache-len", "32",
                       "--max-new", "3"]) == 0
    assert "[serve] 3/3 requests" in capsys.readouterr().out
