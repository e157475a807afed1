"""The vision stub (InternVL2-76B) through the port, against the JAX
package on the CPU.

The reduced config (2 attention layers, d_model 64, 4 query heads over 2
KV heads of 16, SwiGLU, vocab 256, 8 frontend tokens) runs in both
packages with the same weights (``train_compare.model``).  Patch
embeddings and tokens are drawn with numpy.  The stub frontend's patch
embeddings replace the embeddings of the first Nv tokens (they are not
prepended), and the loss leaves the first Nv - 1 targets out, as the
reference's.

Tolerances, atol = rtol: prefill and decode logits 2e-3 with equal greedy
tokens, as ``tests/test_models.py``; ``lm_loss`` and every gradient leaf
1e-4, and 3 train steps as ``train_compare.check_step_run``.
"""
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.models import backbone as jbb  # noqa: E402
from repro.train.data import data_for as jdata_for  # noqa: E402
from repro.train.serve import BatchedServer as JaxServer  # noqa: E402
from repro.train.serve import Request as JaxRequest  # noqa: E402
from repro.train.serve import ServeConfig as JaxServeConfig  # noqa: E402

from repro_torch import configs  # noqa: E402
from repro_torch.models import backbone  # noqa: E402
from repro_torch.models.convert import params_from_reference  # noqa: E402
from repro_torch.train.data import data_for  # noqa: E402
from repro_torch.train.serve import (BatchedServer, Request,  # noqa: E402
                                     ServeConfig)
from repro_torch.train.tree import flatten, unflatten  # noqa: E402

from train_compare import (TOL, assert_tree_close, check_step_run,  # noqa: E402
                           frontend_inputs, jax_tree, model, run_both,
                           tokens)

ARCH = "internvl2-76b"
LOGIT_TOL = 2e-3
STEPS = 8
NV = 4


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), atol=tol,
                               rtol=tol)


def _serving():
    cfg, tree, pcfg, _ = model(ARCH)
    return cfg, jax_tree(tree), pcfg, params_from_reference(pcfg, tree,
                                                            device="cpu")


def _patches(seed, B, n, D):
    return (0.02 * np.random.default_rng(seed).standard_normal(
        (B, n, D))).astype(np.float32)


def _batch(toks, ve):
    return ({"tokens": jnp.asarray(toks), "vision_embeds": jnp.asarray(ve)},
            {"tokens": torch.from_numpy(toks).long(),
             "vision_embeds": torch.from_numpy(ve)})


def test_full_config_is_the_published_one():
    cfg = configs.get_config(ARCH)
    assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
            cfg.head_dim, cfg.d_ff, cfg.vocab, cfg.frontend,
            cfg.n_frontend_tokens) == (80, 8192, 64, 8, 128, 28672, 128256,
                                       "vision", 256)
    assert cfg.param_count() == 70_552_387_584
    assert configs.get_reduced(ARCH).n_frontend_tokens == 8


@pytest.mark.parametrize("seq", [1024, 300, 8])
def test_data_draws_the_patches_as_the_reference(seq):
    """256 patches, at most half the sequence, none for an
    encoder-decoder's frames."""
    full = configs.get_config(ARCH)
    got = data_for(full, 2, seq, device="cpu")
    want = jdata_for(full, 2, seq)
    assert got.cfg.n_vis_tokens == want.cfg.n_vis_tokens == min(256,
                                                                seq // 2)
    assert got.cfg.n_enc_tokens == want.cfg.n_enc_tokens == 0
    assert tuple(got.batch_for_step(3)["vision_embeds"].shape) == (
        2, min(256, seq // 2), 8192)


def test_port_init_has_the_reference_shapes():
    cfg, jparams, pcfg, converted = _serving()
    own = backbone.init_params(pcfg, torch.Generator().manual_seed(0),
                               device="cpu")
    assert jax.tree.map(lambda t: tuple(t.shape), own) == \
        jax.tree.map(lambda t: tuple(t.shape), converted)
    assert "enc" not in own
    assert jax.tree.map(lambda t: tuple(t.shape),
                        backbone.group_params(pcfg, own)) == \
        jax.tree.map(lambda a: tuple(a.shape), jparams)


def test_vision_prefill_and_greedy_decode_match_jax():
    cfg, jparams, pcfg, params = _serving()
    toks = tokens(3, (2, 12), cfg.vocab)
    jb, tb = _batch(toks, _patches(4, 2, NV, cfg.d_model))
    Tp, S = toks.shape[1], 32
    jc = jbb.init_cache(cfg, 2, S, dtype=jnp.float32)
    tc = backbone.init_cache(pcfg, 2, S, dtype=torch.float32, device="cpu")
    jl, jc = jax.jit(lambda p, b, c: jbb.prefill(cfg, p, b, c))(
        jparams, jb, jc)
    tl, tc = backbone.prefill(pcfg, params, tb, tc)
    _close(tl, jl, LOGIT_TOL)
    jdec = jax.jit(lambda p, t, c, pos: jbb.decode_step(cfg, p, t, c, pos))
    for i in range(STEPS):
        jt = jnp.argmax(jl, axis=-1).astype(jnp.int32)
        tt = torch.argmax(tl, dim=-1)
        assert tt.tolist() == np.asarray(jt).tolist()
        jl, jc = jdec(jparams, jt, jc, jnp.int32(Tp + i))
        tl, tc = backbone.decode_step(pcfg, params, tt, tc, Tp + i)
        _close(tl, jl, LOGIT_TOL)


def test_patches_replace_the_first_token_embeddings():
    """The first Nv tokens do not reach the model (their embeddings are
    replaced, the sequence keeps its length); the (Nv + 1)-th does."""
    _, _, pcfg, params = _serving()
    toks = tokens(5, (1, 12), pcfg.vocab)
    ve = torch.from_numpy(_patches(6, 1, NV, pcfg.d_model))

    def run(t):
        caches = backbone.init_cache(pcfg, 1, 32, dtype=torch.float32,
                                     device="cpu")
        return backbone.prefill(pcfg, params, {
            "tokens": torch.from_numpy(t).long(), "vision_embeds": ve},
            caches)[0]
    base = run(toks)
    other = toks.copy()
    other[:, :NV] = (other[:, :NV] + 1) % pcfg.vocab
    assert torch.equal(run(other), base)
    other[:, NV] = (other[:, NV] + 1) % pcfg.vocab
    assert not torch.equal(run(other), base)


def test_decode_matches_dense_forward():
    _, _, pcfg, params = _serving()
    S = 12
    toks = torch.from_numpy(tokens(7, (1, S + 1), pcfg.vocab)).long()
    ve = torch.from_numpy(_patches(8, 1, NV, pcfg.d_model))
    h = backbone.embed_tokens(pcfg, params, toks)
    h = torch.cat([ve, h[:, NV:]], dim=1)
    hf, _, _ = backbone.forward(pcfg, params, h, "train")
    caches = backbone.init_cache(pcfg, 1, 32, dtype=torch.float32,
                                 device="cpu")
    pre, caches = backbone.prefill(pcfg, params, {
        "tokens": toks[:, :S], "vision_embeds": ve}, caches)
    _close(pre, backbone.logits_fn(pcfg, params, hf[:, S - 1]), LOGIT_TOL)
    dec, _ = backbone.decode_step(pcfg, params, toks[:, S], caches, S)
    _close(dec, backbone.logits_fn(pcfg, params, hf[:, S]), LOGIT_TOL)


def test_lm_loss_mask_and_grads_equal_the_reference():
    """The loss leaves the first Nv - 1 targets out (their positions see
    only patches): changing those tokens changes nothing; the loss and
    every gradient equal the reference's."""
    cfg, tree, pcfg, params = model(ARCH)
    toks = tokens(1, (2, 24), cfg.vocab)
    extra = frontend_inputs(cfg, 2, 24, seed=5)
    assert set(extra) == {"vision_embeds"} and \
        extra["vision_embeds"].shape[1] == NV
    jb, tb = _batch(toks, extra["vision_embeds"])
    (jloss, jm), jg = jax.jit(jax.value_and_grad(
        lambda p: jbb.lm_loss(cfg, p, jb), has_aux=True))(jax_tree(tree))
    flat, s = flatten(params)
    xs = [p.detach().requires_grad_(True) for p in flat]
    loss, m = backbone.lm_loss(pcfg, unflatten(s, xs), tb)
    grads = torch.autograd.grad(loss, xs)
    _close(float(loss), float(jloss), TOL)
    _close(float(m["xent"]), float(jm["xent"]), TOL)
    assert_tree_close(jg, unflatten(s, list(grads)))
    with torch.no_grad():
        other = dict(tb, tokens=tb["tokens"].clone())
        other["tokens"][:, :NV] = (other["tokens"][:, :NV] + 1) % cfg.vocab
        assert float(backbone.lm_loss(pcfg, params, other)[0]) == \
            float(backbone.lm_loss(pcfg, params, tb)[0])
        # the mask: Nv - 1 zeros, then ones (the reference's xent with it)
        h = torch.cat([tb["vision_embeds"],
                       backbone.embed_tokens(pcfg, params,
                                             tb["tokens"])[:, NV:]], dim=1)
        hf, _, _ = backbone.forward(pcfg, params, h, "train")
        logits = backbone.logits_fn(pcfg, params, hf[:, :-1])
        mask = np.concatenate([np.zeros((2, NV - 1)), np.ones((2, 24 - NV))],
                              axis=1).astype(np.float32)
        want = jbb._xent(jnp.asarray(logits.numpy()),
                         jnp.asarray(toks[:, 1:]), jnp.asarray(mask))
        _close(float(m["xent"]), float(want), TOL)


@pytest.mark.parametrize("microbatches,factored,compress",
                         [(2, False, False), (1, True, True)],
                         ids=["mb2-adamw-fp32", "mb1-adafactor-int8"])
def test_three_steps_equal_the_reference(microbatches, factored, compress):
    jm, js, tm, ts = run_both(ARCH, microbatches, factored, compress)
    check_step_run(jm, js, tm, ts, factored, compress)


def test_batched_server_refuses_as_the_reference():
    """The reference's server gives a vision config no patch embeddings,
    so its prefill raises ``KeyError('vision_embeds')`` at the first
    admission; the port's does the same."""
    cfg, jparams, pcfg, params = _serving()
    jsrv = JaxServer(cfg, jparams, JaxServeConfig(slots=2, cache_len=32))
    tsrv = BatchedServer(pcfg, params, ServeConfig(slots=2, cache_len=32),
                         device="cpu")
    prompt = tokens(9, (10,), cfg.vocab)
    jsrv.submit(JaxRequest(rid=0, prompt=prompt, max_new=4))
    tsrv.submit(Request(rid=0, prompt=prompt, max_new=4))
    with pytest.raises(KeyError, match="vision_embeds") as jerr:
        jsrv.step()
    with pytest.raises(KeyError, match="vision_embeds") as terr:
        tsrv.step()
    assert terr.value.args == jerr.value.args == ("vision_embeds",)
