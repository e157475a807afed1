"""The encoder-decoder (Whisper-large-v3) through the port, against the JAX
package on the CPU.

The reduced config (2 encoder and 2 decoder layers, d_model 64, 4 query
heads over 2 KV heads of 16, a plain GELU MLP with biases, LayerNorm,
vocab 256) runs in both packages with the same weights: the reference's
``init_params`` tree, its zero norm weights and biases replaced by seeded
noise (``train_compare.model``), carried across by
``repro_torch.models.convert``.  Frame embeddings and tokens are drawn
with numpy.  The JAX side runs its default kernel backend (the jnp
oracles), the port its plain versions (CPU tensors).

Tolerances, atol = rtol: fp32 modules (``sinusoid_pos``, the MLP,
``cross_apply``, ``encode``) 1e-5; the whole model's logits 2e-3 with
equal greedy tokens, as ``tests/test_models.py``; ``lm_loss`` and every
gradient leaf 1e-4, and 3 train steps as ``train_compare.check_step_run``.
"""
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.models import backbone as jbb  # noqa: E402
from repro.models import blocks as jblocks  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro.train.data import data_for as jdata_for  # noqa: E402
from repro.train.serve import BatchedServer as JaxServer  # noqa: E402
from repro.train.serve import Request as JaxRequest  # noqa: E402
from repro.train.serve import ServeConfig as JaxServeConfig  # noqa: E402

from repro_torch import configs  # noqa: E402
from repro_torch.launch.serve import main as serve_main  # noqa: E402
from repro_torch.models import backbone, blocks, layers  # noqa: E402
from repro_torch.models.convert import (  # noqa: E402
    grouped_params_from_reference, params_from_reference)
from repro_torch.train.data import data_for  # noqa: E402
from repro_torch.train.serve import (BatchedServer, Request,  # noqa: E402
                                     ServeConfig)
from repro_torch.train.tree import flatten, unflatten  # noqa: E402

from train_compare import (TOL, assert_tree_close, check_step_run,  # noqa: E402
                           frontend_inputs, jax_tree, model, run_both,
                           tokens)

ARCH = "whisper-large-v3"
FP32_TOL = 1e-5
LOGIT_TOL = 2e-3
STEPS = 8
S_ENC = 8


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), atol=tol,
                               rtol=tol)


def _serving():
    cfg, tree, pcfg, _ = model(ARCH)
    return cfg, jax_tree(tree), pcfg, params_from_reference(pcfg, tree,
                                                            device="cpu")


def _frames(seed, B, S, D):
    return (0.02 * np.random.default_rng(seed).standard_normal(
        (B, S, D))).astype(np.float32)


def _layer(tree, i=0):
    """Decoder layer i of the reference tree, unstacked, as numpy."""
    return jax.tree.map(lambda a: np.asarray(a)[i], tree["groups"][0])


# --------------------------------------------------------------------------- #
# config and data                                                              #
# --------------------------------------------------------------------------- #
def test_full_config_is_the_published_one():
    cfg = configs.get_config(ARCH)
    assert (cfg.encoder_layers, cfg.n_layers, cfg.d_model, cfg.n_heads,
            cfg.n_kv_heads, cfg.head_dim, cfg.d_ff, cfg.vocab) == \
        (32, 32, 1280, 20, 20, 64, 5120, 51866)
    assert cfg.param_count() == 1_600_783_360
    assert configs.get_reduced(ARCH).encoder_layers == 2


def test_data_draws_whispers_1500_frames_as_the_reference():
    """``data_for`` gives an encoder-decoder 1,500 frames (30 s of audio)
    by default, and ``n_enc`` frames when asked, as the reference's."""
    full = configs.get_config(ARCH)
    for n_enc in (None, 64):
        got = data_for(full, 2, 16, n_enc=n_enc, device="cpu")
        want = jdata_for(full, 2, 16, n_enc=n_enc)
        assert got.cfg.n_enc_tokens == want.cfg.n_enc_tokens == (n_enc
                                                                 or 1500)
        assert got.cfg.n_vis_tokens == want.cfg.n_vis_tokens == 0
        b = got.batch_for_step(0)
        assert tuple(b["enc_embeds"].shape) == (2, n_enc or 1500, 1280)
        assert b["enc_embeds"].dtype == torch.float32


# --------------------------------------------------------------------------- #
# layers and the cross-attention block                                         #
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("T,d,offset", [(1500, 1280, 0), (7, 64, 0),
                                        (5, 16, 9)])
def test_sinusoid_pos_equals_the_reference(T, d, offset):
    got = layers.sinusoid_pos(T, d, offset)
    assert tuple(got.shape) == (T, d) and got.dtype == torch.float32
    _close(got, jlayers.sinusoid_pos(T, d, offset), FP32_TOL)


def test_the_plain_gelu_mlp_equals_the_reference():
    """Whisper's MLP: wi / bi / wo / bo, the tanh-approximated GELU (the
    default of ``jax.nn.gelu``); biases drawn nonzero here."""
    rng = np.random.default_rng(0)
    d, f = 64, 128
    p = {"wi": rng.standard_normal((d, f)) / 8, "bi": rng.standard_normal(f),
         "wo": rng.standard_normal((f, d)) / 11,
         "bo": rng.standard_normal(d)}
    p = {k: v.astype(np.float32) for k, v in p.items()}
    x = rng.standard_normal((2, 5, d)).astype(np.float32)
    want = jlayers.mlp_apply({k: jnp.asarray(v) for k, v in p.items()},
                             jnp.asarray(x), "gelu")
    got = layers.mlp_apply({k: torch.from_numpy(v) for k, v in p.items()},
                           torch.from_numpy(x), "gelu")
    _close(got, want, FP32_TOL)
    own = layers.mlp_init(torch.Generator().manual_seed(0), d, f, "gelu",
                          torch.float32, "cpu")
    ref, _ = jlayers.mlp_init(jax.random.PRNGKey(0), d, f, "gelu")
    assert {k: tuple(v.shape) for k, v in own.items()} == \
        {k: tuple(v.shape) for k, v in ref.items()}
    assert not own["bi"].any() and not own["bo"].any()


def test_cross_attention_init_has_no_qk_norm():
    cfg = configs.get_reduced("qwen3-8b")            # a qk_norm config
    gen = torch.Generator().manual_seed(0)
    own = blocks.attn_init(cfg, gen, torch.float32, "cpu", cross=True)
    ref, _ = jblocks.attn_init(jax.random.PRNGKey(0), cfg, cross=True)
    assert set(own) == set(ref) == {"ln", "wq", "wk", "wv", "wo"}
    assert "qn" in blocks.attn_init(cfg, gen, torch.float32, "cpu")


def test_cross_apply_prefill_and_decode_equal_the_reference():
    """Prefill attends over every frame (non-causal, Tk = 8 > Tq = 5) and
    fills the cross cache; decode reads it back with ``cur_len = S_enc``;
    the cache equals the K/V of the reference's prefill."""
    cfg, tree, pcfg, _ = model(ARCH)
    lp = _layer(tree)["cross"]
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 5, cfg.d_model)).astype(np.float32)
    enc = rng.standard_normal((2, S_ENC, cfg.d_model)).astype(np.float32)
    jp = jax_tree(lp)
    tp = {k: torch.from_numpy(np.array(v)) for k, v in lp.items()}
    jc = jblocks.cross_cache(cfg, 2, S_ENC, jnp.float32)
    tc = blocks.cross_cache(pcfg, 2, S_ENC, torch.float32, "cpu")
    jy, jc = jblocks.cross_apply(cfg, jp, jnp.asarray(x), "prefill", jc,
                                 jnp.asarray(enc))
    ty, tc2 = blocks.cross_apply(pcfg, tp, torch.from_numpy(x), "prefill", tc,
                                 torch.from_numpy(enc))
    assert tc2 is tc
    _close(ty, jy, FP32_TOL)
    for k in ("ck", "cv"):
        assert tuple(tc[k].shape) == tuple(jc[k].shape)
        _close(tc[k], jc[k], FP32_TOL)
    x1 = x[:, :1] * 0.5
    jy, _ = jblocks.cross_apply(cfg, jp, jnp.asarray(x1), "decode", jc, None)
    ty, _ = blocks.cross_apply(pcfg, tp, torch.from_numpy(x1), "decode", tc,
                               None)
    _close(ty, jy, FP32_TOL)
    # train mode: the same attention, no cache
    jy, _ = jblocks.cross_apply(cfg, jp, jnp.asarray(x), "train", None,
                                jnp.asarray(enc))
    ty, _ = blocks.cross_apply(pcfg, tp, torch.from_numpy(x), "train", None,
                               torch.from_numpy(enc))
    _close(ty, jy, FP32_TOL)


def test_cross_cache_of_no_frames_keeps_nothing_and_decodes_zero():
    """The reference's server prefills into a cross cache of 0 frames and
    sets the slot back, which drops the frames' K/V; the port's prefill
    writes nothing there and raises nothing, and a decode over no frame
    adds 0.  A cache of another length than the frames' is refused, as the
    reference's slot write refuses it."""
    cfg, tree, pcfg, _ = model(ARCH)
    tp = {k: torch.from_numpy(np.array(v))
          for k, v in _layer(tree)["cross"].items()}
    rng = np.random.default_rng(2)
    x = torch.from_numpy(rng.standard_normal((1, 3, 64)).astype(np.float32))
    enc = torch.from_numpy(rng.standard_normal((1, S_ENC, 64)).astype(
        np.float32))
    empty = blocks.cross_cache(pcfg, 1, 0, torch.bfloat16, "cpu")
    blocks.cross_apply(pcfg, tp, x, "prefill", empty, enc)
    assert tuple(empty["ck"].shape) == (1, 0, pcfg.n_kv_heads, 16)
    y, _ = blocks.cross_apply(pcfg, tp, x[:, :1], "decode", empty, None)
    assert torch.equal(y, x[:, :1])
    # the reference's slot write of 8 frames into its empty cross cache
    ck = jbb.init_cache(cfg, 2, 32)["groups"][0]["cross"]["ck"]
    frames = jnp.ones(ck.shape[:1] + (1, S_ENC) + ck.shape[3:], ck.dtype)
    assert ck.at[:, 1:2].set(frames).shape == ck.shape
    with pytest.raises(ValueError, match="cross cache of 4 frames"):
        blocks.cross_apply(pcfg, tp, x, "prefill", blocks.cross_cache(
            pcfg, 1, 4, torch.float32, "cpu"), enc)


# --------------------------------------------------------------------------- #
# parameters                                                                   #
# --------------------------------------------------------------------------- #
def test_port_init_has_the_reference_shapes():
    cfg, jparams, pcfg, converted = _serving()
    own = backbone.init_params(pcfg, torch.Generator().manual_seed(0),
                               device="cpu")
    assert jax.tree.map(lambda t: tuple(t.shape), own) == \
        jax.tree.map(lambda t: tuple(t.shape), converted)
    assert len(own["enc"]["layers"]) == cfg.encoder_layers == 2
    assert set(own["layers"][0]) == {"mix", "cross", "mlp"}
    assert set(own["layers"][0]["mlp"]) == {"ln", "wi", "bi", "wo", "bo"}
    grouped = backbone.group_params(pcfg, own)
    assert jax.tree.map(lambda t: tuple(t.shape), grouped) == \
        jax.tree.map(lambda a: tuple(a.shape), jparams)


def test_convert_carries_enc_in_both_layouts():
    cfg, tree, pcfg, grouped = model(ARCH)
    serving = params_from_reference(pcfg, tree, device="cpu")
    assert set(serving["enc"]) == {"layers", "final_norm"}
    assert set(grouped["enc"]) == set(tree["enc"]) == {"groups",
                                                        "final_norm"}
    want = jax.tree.leaves(tree["enc"])
    for got in (flatten(grouped["enc"])[0],
                flatten(backbone.group_params(pcfg, serving)["enc"])[0]):
        assert len(got) == len(want) > 8
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    for i, layer in enumerate(serving["enc"]["layers"]):
        for a, b in zip(flatten(layer)[0], jax.tree.leaves(tree["enc"][
                "groups"][0])):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b)[i])
    again = grouped_params_from_reference(pcfg, tree, device="cpu")
    assert set(again) == set(tree) == {"embed", "groups", "final_norm",
                                       "head", "enc"}


# --------------------------------------------------------------------------- #
# the encoder and the whole model                                              #
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("layout", ["serving", "training"])
def test_encode_equals_the_reference(layout):
    """Sinusoid positions, bidirectional attention with RoPE (the
    reference's ``attn_apply`` applies it), the encoder's final norm."""
    cfg, tree, pcfg, grouped = model(ARCH)
    params = (params_from_reference(pcfg, tree, device="cpu")
              if layout == "serving" else grouped)
    enc = _frames(3, 2, 24, cfg.d_model)
    want = jbb.encode(cfg, jax_tree(tree), jnp.asarray(enc))
    got = backbone.encode(pcfg, params, torch.from_numpy(enc))
    _close(got, want, FP32_TOL)


def test_prefill_and_greedy_decode_match_jax():
    cfg, jparams, pcfg, params = _serving()
    toks = tokens(3, (2, 12), cfg.vocab)
    enc = _frames(4, 2, S_ENC, cfg.d_model)
    Tp, S = toks.shape[1], 32
    jc = jbb.init_cache(cfg, 2, S, S_enc=S_ENC, dtype=jnp.float32)
    tc = backbone.init_cache(pcfg, 2, S, S_enc=S_ENC, dtype=torch.float32,
                             device="cpu")
    jl, jc = jax.jit(lambda p, t, e, c: jbb.prefill(
        cfg, p, {"tokens": t, "enc_embeds": e}, c))(
        jparams, jnp.asarray(toks), jnp.asarray(enc), jc)
    tl, tc = backbone.prefill(pcfg, params, {
        "tokens": torch.from_numpy(toks).long(),
        "enc_embeds": torch.from_numpy(enc)}, tc)
    _close(tl, jl, LOGIT_TOL)
    for i, layer in enumerate(tc):       # the cross caches the reference's
        for k in ("ck", "cv"):
            _close(layer["cross"][k], jc["groups"][0]["cross"][k][i],
                   LOGIT_TOL)
    jdec = jax.jit(lambda p, t, c, pos: jbb.decode_step(cfg, p, t, c, pos))
    for i in range(STEPS):
        jt = jnp.argmax(jl, axis=-1).astype(jnp.int32)
        tt = torch.argmax(tl, dim=-1)
        assert tt.tolist() == np.asarray(jt).tolist()
        jl, jc = jdec(jparams, jt, jc, jnp.int32(Tp + i))
        tl, tc = backbone.decode_step(pcfg, params, tt, tc, Tp + i)
        _close(tl, jl, LOGIT_TOL)


def test_decode_matches_dense_forward():
    """The reference's ``test_decode_matches_dense_forward`` for Whisper,
    on the port: prefill of 12 tokens then one decode step equal the
    forward over 13 tokens with the same encoder output."""
    _, _, pcfg, params = _serving()
    S = 12
    toks = torch.from_numpy(tokens(7, (1, S + 1), pcfg.vocab)).long()
    enc = torch.from_numpy(_frames(8, 1, S_ENC, pcfg.d_model))
    enc_out = backbone.encode(pcfg, params, enc)
    hf, _, _ = backbone.forward(pcfg, params, backbone.embed_tokens(
        pcfg, params, toks), "train", enc_out=enc_out)
    caches = backbone.init_cache(pcfg, 1, 32, S_enc=S_ENC,
                                 dtype=torch.float32, device="cpu")
    pre, caches = backbone.prefill(pcfg, params, {"tokens": toks[:, :S],
                                                  "enc_embeds": enc}, caches)
    _close(pre, backbone.logits_fn(pcfg, params, hf[:, S - 1]), LOGIT_TOL)
    dec, _ = backbone.decode_step(pcfg, params, toks[:, S], caches, S)
    _close(dec, backbone.logits_fn(pcfg, params, hf[:, S]), LOGIT_TOL)


# --------------------------------------------------------------------------- #
# training                                                                     #
# --------------------------------------------------------------------------- #
def test_lm_loss_and_grads_equal_the_reference():
    cfg, tree, pcfg, params = model(ARCH)
    toks = tokens(1, (2, 24), cfg.vocab)
    extra = frontend_inputs(cfg, 2, 24, seed=5)
    assert set(extra) == {"enc_embeds"}

    def f(p):
        return jbb.lm_loss(cfg, p, {"tokens": jnp.asarray(toks),
                                    **{k: jnp.asarray(v)
                                       for k, v in extra.items()}})
    (jloss, jm), jg = jax.jit(jax.value_and_grad(f, has_aux=True))(
        jax_tree(tree))
    flat, s = flatten(params)
    xs = [p.detach().requires_grad_(True) for p in flat]
    loss, m = backbone.lm_loss(pcfg, unflatten(s, xs), {
        "tokens": torch.from_numpy(toks).long(),
        **{k: torch.from_numpy(v) for k, v in extra.items()}})
    grads = torch.autograd.grad(loss, xs)
    _close(float(loss), float(jloss), TOL)
    _close(float(m["xent"]), float(jm["xent"]), TOL)
    assert float(m["aux"]) == float(jm["aux"]) == 0.0
    assert_tree_close(jg, unflatten(s, list(grads)))
    # the encoder's leaves get gradients through the cross-attention
    enc_grads = flatten(unflatten(s, list(grads))["enc"])[0]
    assert all(float(g.abs().max()) > 0 for g in enc_grads)


@pytest.mark.parametrize("microbatches,factored,compress",
                         [(1, False, False), (2, True, True)],
                         ids=["mb1-adamw-fp32", "mb2-adafactor-int8"])
def test_three_steps_equal_the_reference(microbatches, factored, compress):
    jm, js, tm, ts = run_both(ARCH, microbatches, factored, compress)
    check_step_run(jm, js, tm, ts, factored, compress)


# --------------------------------------------------------------------------- #
# serving: the reference's server fault, mirrored                              #
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("cache", ["bfloat16", "float32"])
def test_batched_server_matches_jax_greedy(cache):
    """The reference's server encodes 8 zero frames at prefill into a
    cross cache of 0 frames (``init_cache`` without ``S_enc``), so decode
    attends to no frame.  The port mirrors it: five requests through two
    slots give the reference's greedy tokens, request for request, and
    the cross caches stay empty."""
    cfg, jparams, pcfg, params = _serving()
    lens, max_new = [5, 13, 9, 13, 5], 6
    jsrv = JaxServer(cfg, jparams, JaxServeConfig(slots=2, cache_len=32))
    tsrv = BatchedServer(pcfg, params, ServeConfig(slots=2, cache_len=32),
                         device="cpu")
    if cache == "float32":
        jsrv.caches = jbb.init_cache(cfg, 2, 32, dtype=jnp.float32)
        tsrv.caches = backbone.init_cache(pcfg, 2, 32, dtype=torch.float32,
                                          device="cpu")
    jreqs = [JaxRequest(rid=i, prompt=tokens(10 + i, (n,), cfg.vocab),
                        max_new=max_new) for i, n in enumerate(lens)]
    treqs = [Request(rid=i, prompt=tokens(10 + i, (n,), cfg.vocab),
                     max_new=max_new) for i, n in enumerate(lens)]
    for jr, tr in zip(jreqs, treqs):
        jsrv.submit(jr)
        tsrv.submit(tr)
    jsrv.run_until_drained()
    assert 0 < tsrv.run_until_drained() < 10_000
    assert all(r.done and len(r.out) == max_new for r in treqs)
    assert [r.out for r in treqs] == [r.out for r in jreqs]
    assert jsrv.caches["groups"][0]["cross"]["ck"].shape[2] == 0
    for layer in tsrv.caches:
        assert layer["cross"]["ck"].shape[1] == 0
        assert layer["mix"]["k"].any()


def test_the_serving_launcher_serves_whisper_on_the_cpu(capsys):
    assert serve_main(["--arch", "whisper-large-v3", "--reduced",
                       "--device", "cpu", "--requests", "3", "--slots", "2",
                       "--cache-len", "32", "--max-new", "3"]) == 0
    assert "[serve] 3/3 requests" in capsys.readouterr().out
