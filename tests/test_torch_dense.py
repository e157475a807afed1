"""The dense decoder family (Llama-3-8B, Qwen3-8B, SmolLM-360M,
Granite-3-2B) and the int8 KV-cache layout, the port against the JAX
package on the CPU.

Each reduced config (2 layers, d_model 64, 4 query heads over 2 KV heads,
vocab 256) runs in both packages with the same weights: the reference's
``init_params`` tree, its zero-initialised norm weights replaced by seeded
noise so that ``qk_norm`` and the (1 + w) scales do work, carried across by
``repro_torch.models.convert``.  The JAX side runs its default kernel
backend (the jnp oracles), the port its plain versions (CPU tensors).

Tolerances: fp32 parameters and caches, prefill logits and 8 greedy decode
steps within 2e-3 (atol = rtol; the same arithmetic summed in another
order), with equal greedy tokens.  The int8 layout: the int8 ``k``/``v``
equal the reference's (an fp32 value a few ulps apart could round to the
neighbouring level, and none does on these inputs), the fp32 scales within
1e-6 relative, decode logits within 2e-3 of the reference's int8 run, and
int8 against fp within 5 % of the logits' scale, the reference's own bound
(``tests/test_models.py``).
"""
import dataclasses

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.models import backbone as jbb  # noqa: E402
from repro.train.serve import BatchedServer as JaxServer  # noqa: E402
from repro.train.serve import Request as JaxRequest  # noqa: E402
from repro.train.serve import ServeConfig as JaxServeConfig  # noqa: E402

from repro_torch import configs  # noqa: E402
from repro_torch.models import backbone, blocks  # noqa: E402
from repro_torch.models.convert import params_from_reference  # noqa: E402
from repro_torch.train.serve import (BatchedServer, Request,  # noqa: E402
                                     ServeConfig)

DENSE = ("llama3-8b", "qwen3-8b", "smollm-360m", "granite-3-2b")
TOL = 2e-3
STEPS = 8
SCALE_RTOL = 1e-6


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), atol=tol,
                               rtol=tol)


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _tokens(seed, shape, vocab):
    return np.random.default_rng(seed).integers(1, vocab, size=shape).astype(
        np.int32)


def _noisy_norms(tree, rng):
    """The tree with every all-zero leaf (the norm weights) replaced by
    seeded noise of scale 0.1."""
    if isinstance(tree, dict):
        return {k: _noisy_norms(v, rng) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_noisy_norms(v, rng) for v in tree]
    a = np.asarray(tree)
    if a.dtype == np.float32 and not a.any():
        return (0.1 * rng.standard_normal(a.shape)).astype(np.float32)
    return a


_MODELS = {}


def _model(arch):
    """(config, JAX params, the port's params) of the reduced config."""
    if arch not in _MODELS:
        cfg = jconfigs.get_reduced(arch)
        jparams, _ = jbb.init_params(cfg, jax.random.PRNGKey(0))
        tree = _noisy_norms(jax.tree.map(np.asarray, jparams),
                            np.random.default_rng(7))
        _MODELS[arch] = (cfg, jax.tree.map(jnp.asarray, tree),
                         params_from_reference(configs.get_reduced(arch),
                                               tree, device="cpu"))
    return _MODELS[arch]


def _run(cfg, jparams, params, toks, S, jdtype, tdtype, steps=STEPS):
    """Prefill both packages on ``toks`` and decode ``steps`` greedy tokens
    (each side feeding its own picks).  Returns the per-step logits and
    picks of each side, and both final caches."""
    B, T = toks.shape
    jc = jbb.init_cache(cfg, B, S, dtype=jdtype)
    tc = backbone.init_cache(cfg, B, S, dtype=tdtype, device="cpu")
    jl, jc = jbb.prefill(cfg, jparams, {"tokens": jnp.asarray(toks)}, jc)
    tl, tc = backbone.prefill(cfg, params, {"tokens": _t(toks).long()}, tc)
    jout, tout, jpick, tpick = [jl], [tl], [], []
    for i in range(steps):
        jt = jnp.argmax(jout[-1], axis=-1).astype(jnp.int32)
        tt = torch.argmax(tout[-1], dim=-1)
        jpick.append(np.asarray(jt).tolist())
        tpick.append(tt.tolist())
        jl, jc = jbb.decode_step(cfg, jparams, jt, jc, jnp.int32(T + i))
        tl, tc = backbone.decode_step(cfg, params, tt, tc, T + i)
        jout.append(jl)
        tout.append(tl)
    return jout, tout, jpick, tpick, jc, tc


# --------------------------------------------------------------------------- #
# configs and the shape registry                                               #
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("arch", DENSE)
def test_config_equals_the_reference_field_for_field(arch):
    asdict = dataclasses.asdict
    assert asdict(configs.get_config(arch)) == \
        asdict(jconfigs.get_config(arch))
    assert asdict(configs.get_reduced(arch)) == \
        asdict(jconfigs.get_reduced(arch))
    assert configs.get_config(arch).param_count() == \
        jconfigs.get_config(arch).param_count()


def test_archs_keep_the_reference_order_and_aliases():
    assert configs.ARCHS == tuple(a for a in jconfigs.ARCHS
                                  if a in configs.ARCHS)
    assert set(configs.ARCHS) == {"qwen2_moe_a2_7b", "deepseek_v3_671b",
                                  "qwen3_8b", "granite_3_2b", "smollm_360m",
                                  "llama3_8b", "rwkv6_7b",
                                  "recurrentgemma_2b"}
    assert configs.ALIASES == {k: v for k, v in jconfigs.ALIASES.items()
                               if k in configs.ALIASES}
    assert {k for k, v in jconfigs.ALIASES.items()
            if v in configs.ARCHS} <= set(configs.ALIASES)
    for name in ("whisper-large-v3", "internvl2-76b"):
        with pytest.raises(KeyError, match="ROADMAP"):
            configs.get_config(name)


def test_shapes_and_cells_equal_the_reference():
    assert {k: dataclasses.asdict(v) for k, v in configs.SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in jconfigs.SHAPES.items()}
    assert configs.all_cells() == [c for c in jconfigs.all_cells()
                                   if c[0] in configs.ARCHS]
    assert len(configs.all_cells()) == 4 * len(configs.ARCHS)
    for arch in configs.ARCHS:
        for name, shape in configs.SHAPES.items():
            assert configs.shape_applicable(configs.get_config(arch), shape) \
                == jconfigs.shape_applicable(jconfigs.get_config(arch),
                                             jconfigs.SHAPES[name])


# --------------------------------------------------------------------------- #
# the reduced models against the reference                                     #
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("arch", DENSE)
def test_prefill_and_greedy_decode_match_jax(arch):
    cfg, jparams, params = _model(arch)
    toks = _tokens(3, (2, 12), cfg.vocab)
    jout, tout, jpick, tpick, _, _ = _run(cfg, jparams, params, toks, 32,
                                          jnp.float32, torch.float32)
    for tl, jl in zip(tout, jout):
        _close(tl, jl)
    assert tpick == jpick


def test_tied_embeddings_have_no_head():
    for arch, tied in (("smollm-360m", True), ("granite-3-2b", True),
                       ("llama3-8b", False), ("qwen3-8b", False)):
        _, jparams, params = _model(arch)
        assert ("head" in params) == ("head" in jparams) == (not tied)
    assert configs.get_config("granite-3-2b").vocab == 49155
    assert "qn" in _model("qwen3-8b")[2]["layers"][0]["mix"]


def test_batched_server_matches_jax_greedy():
    """Five requests through two slots of reduced Llama (slots reused, the
    queue FCFS), fp32 parameters, the default bf16 cache: identical greedy
    tokens, request for request."""
    cfg, jparams, params = _model("llama3-8b")
    lens, max_new = [5, 20, 9, 13, 3], 6
    jsrv = JaxServer(cfg, jparams, JaxServeConfig(slots=2, cache_len=32))
    tsrv = BatchedServer(cfg, params, ServeConfig(slots=2, cache_len=32),
                         device="cpu")
    jreqs = [JaxRequest(rid=i, prompt=_tokens(10 + i, (n,), cfg.vocab),
                        max_new=max_new) for i, n in enumerate(lens)]
    treqs = [Request(rid=i, prompt=_tokens(10 + i, (n,), cfg.vocab),
                     max_new=max_new) for i, n in enumerate(lens)]
    for jr, tr in zip(jreqs, treqs):
        jsrv.submit(jr)
        tsrv.submit(tr)
    jsrv.run_until_drained()
    assert 0 < tsrv.run_until_drained() < 10_000
    assert all(r.done and len(r.out) == max_new for r in treqs)
    assert [r.out for r in treqs] == [r.out for r in jreqs]


# --------------------------------------------------------------------------- #
# the int8 KV-cache layout                                                     #
# --------------------------------------------------------------------------- #
def test_int8_cache_layout():
    cfg = configs.get_reduced("llama3-8b")
    caches = backbone.init_cache(cfg, 2, 32, dtype=torch.int8, device="cpu")
    for c in caches:
        mix = c["mix"]
        assert set(mix) == {"k", "v", "ks", "vs"}
        assert mix["k"].dtype == mix["v"].dtype == torch.int8
        assert mix["ks"].dtype == mix["vs"].dtype == torch.float32
        assert tuple(mix["ks"].shape) == (2, 32, cfg.n_kv_heads)
    assert "int8" not in blocks._LATER


@pytest.mark.parametrize("seed", [0, 1])
def test_kv_quant_equals_the_reference(seed):
    from repro.models import blocks as jblocks
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((2, 9, 3, 16)) * rng.uniform(
        0.01, 10.0, (2, 9, 3, 1))).astype(np.float32)
    x[0, 0, 0] = 0.0                         # an all-zero row: scale 1e-12
    jq, js = jblocks._kv_quant(jnp.asarray(x))
    tq, ts = blocks._kv_quant(_t(x))
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=SCALE_RTOL)
    for dt, jdt in ((torch.float32, jnp.float32),
                    (torch.bfloat16, jnp.bfloat16)):
        got = blocks._kv_dequant(tq, ts, dt).float().numpy()
        want = np.asarray(jblocks._kv_dequant(jq, js, jdt), np.float32)
        np.testing.assert_allclose(got, want, rtol=SCALE_RTOL)


def _mix(tc, jc, layer, name):
    """One layer's cache entry of each side (the reference's is stacked
    in its one group)."""
    return tc[layer]["mix"][name], np.asarray(jc["groups"][0]["mix"][name][
        layer])


@pytest.mark.parametrize("arch", ["llama3-8b", "qwen3-8b"])
def test_int8_prefill_and_decode_match_jax(arch):
    """The int8 run of each package: after the prefill and 8 decode steps
    the caches hold equal int8 values and scales within 1e-6, and every
    step's logits agree within 2e-3."""
    cfg, jparams, params = _model(arch)
    toks = _tokens(4, (2, 12), cfg.vocab)
    jout, tout, jpick, tpick, jc, tc = _run(cfg, jparams, params, toks, 32,
                                            jnp.int8, torch.int8)
    for tl, jl in zip(tout, jout):
        _close(tl, jl)
    assert tpick == jpick
    for layer in range(cfg.n_layers):
        for name in ("k", "v"):
            got, want = _mix(tc, jc, layer, name)
            assert got.dtype == torch.int8 and want.dtype == np.int8
            np.testing.assert_array_equal(got.numpy(), want)
        for name in ("ks", "vs"):
            got, want = _mix(tc, jc, layer, name)
            np.testing.assert_allclose(got.numpy(), want, rtol=SCALE_RTOL)
    # the slots written: the prompt's 12 and the 8 decoded positions
    assert bool((tc[0]["mix"]["ks"][:, :12 + STEPS] > 0).all())
    assert not tc[0]["mix"]["ks"][:, 12 + STEPS:].any()


def test_int8_kv_cache_decode_close_to_fp():
    """As the reference's test: one prefill and one decode step, int8
    against fp, within 5 % of the logits' scale."""
    cfg, _, params = _model("llama3-8b")
    B, S = 2, 12
    toks = _t(_tokens(5, (B, S), cfg.vocab)).long()
    outs = {}
    for name, dt in (("fp", torch.float32), ("int8", torch.int8)):
        caches = backbone.init_cache(cfg, B, 32, dtype=dt, device="cpu")
        if name == "int8":
            assert any(t.dtype == torch.int8 for c in caches
                       for t in c["mix"].values()), "int8 layout must be used"
        _, caches = backbone.prefill(cfg, params, {"tokens": toks}, caches)
        outs[name], _ = backbone.decode_step(
            cfg, params, torch.ones(B, dtype=torch.long), caches, S)
    err = float((outs["fp"] - outs["int8"]).abs().max())
    scale = float(outs["fp"].abs().max())
    assert 0.0 < err < 0.05 * max(scale, 1.0)


def test_int8_batched_decode_writes_each_slot():
    """Per-request positions (the server's decode): each row quantizes
    into its own slot, as the reference's scatter does."""
    cfg, jparams, params = _model("smollm-360m")
    B, T, S = 3, 6, 16
    toks = _tokens(6, (B, T), cfg.vocab)
    jc = jbb.init_cache(cfg, B, S, dtype=jnp.int8)
    tc = backbone.init_cache(cfg, B, S, dtype=torch.int8, device="cpu")
    _, jc = jbb.prefill(cfg, jparams, {"tokens": jnp.asarray(toks)}, jc)
    _, tc = backbone.prefill(cfg, params, {"tokens": _t(toks).long()}, tc)
    pos = np.array([6, 9, 15], np.int32)
    nxt = _tokens(7, (B,), cfg.vocab)
    jl, jc = jbb.decode_step(cfg, jparams, jnp.asarray(nxt), jc,
                             jnp.asarray(pos))
    tl, tc = backbone.decode_step(cfg, params, _t(nxt).long(), tc,
                                  _t(pos.astype(np.int64)))
    _close(tl, jl)
    for name in ("k", "ks", "v", "vs"):
        got, want = _mix(tc, jc, 1, name)
        np.testing.assert_allclose(got.float().numpy(),
                                   want.astype(np.float32), rtol=SCALE_RTOL)
