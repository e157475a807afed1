"""Shared pieces of the training tests (``test_torch_train*.py``): the
reduced models in both packages with the same weights, seeded tokens, and
leaf-by-leaf comparisons of a JAX tree with the port's.

The weights are the reference's ``init_params`` tree with its all-zero
leaves (the norm weights) replaced by seeded noise of scale 0.1, so that
the (1 + w) scales and ``qk_norm`` do work, carried across as numpy into
the port's training layout (``grouped_params_from_reference``).
"""
import functools

import numpy as np
import torch

import jax
import jax.numpy as jnp
import jax.tree_util as jtu

from repro import configs as jconfigs
from repro.models import backbone as jbb

from repro_torch import configs
from repro_torch.models.convert import grouped_params_from_reference
from repro_torch.train.tree import flatten

FAMILIES = ("smollm-360m", "llama3-8b", "qwen3-8b", "granite-3-2b",
            "recurrentgemma-2b", "rwkv6-7b")
TOL = 1e-4                 # atol = rtol, fp32
BF16_RTOL = 2.0 ** -7      # one bf16 rounding step, relative


def noisy_norms(tree, rng):
    if isinstance(tree, dict):
        return {k: noisy_norms(v, rng) for k, v in tree.items()}
    if isinstance(tree, list):
        return [noisy_norms(v, rng) for v in tree]
    a = np.asarray(tree)
    if a.dtype == np.float32 and not a.any():
        return (0.1 * rng.standard_normal(a.shape)).astype(np.float32)
    return a


@functools.lru_cache(maxsize=None)
def model(arch):
    """(reference config, reference params as numpy, port config, port
    params in the training layout on the CPU), made once a process; the
    callers do not write them."""
    cfg = jconfigs.get_reduced(arch)
    jparams, _ = jbb.init_params(cfg, jax.random.PRNGKey(0))
    tree = noisy_norms(jax.tree.map(np.asarray, jparams),
                       np.random.default_rng(7))
    pcfg = configs.get_reduced(arch)
    return cfg, tree, pcfg, grouped_params_from_reference(pcfg, tree,
                                                          device="cpu")


def tokens(seed, shape, vocab):
    return np.random.default_rng(seed).integers(0, vocab, size=shape).astype(
        np.int32)


def frontend_inputs(cfg, B, T, seed):
    """The stub frontends' inputs a config's batch needs, as numpy:
    ``enc_embeds`` (B, 8, D) for an encoder-decoder, ``vision_embeds`` (B,
    min(4, T // 2), D) for a vision config, 0.02 x a standard normal."""
    rng = np.random.default_rng(seed)
    out = {}
    if cfg.is_encdec:
        out["enc_embeds"] = 0.02 * rng.standard_normal((B, 8, cfg.d_model))
    if cfg.frontend == "vision":
        out["vision_embeds"] = 0.02 * rng.standard_normal(
            (B, min(4, T // 2), cfg.d_model))
    return {k: v.astype(np.float32) for k, v in out.items()}


def jax_tree(tree):
    return jax.tree.map(jnp.asarray, tree)


def named_leaves(tree):
    """[(path, numpy leaf)] of a JAX tree, in JAX's order."""
    return [(jtu.keystr(p), np.asarray(x))
            for p, x in jtu.tree_flatten_with_path(tree)[0]]


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x).astype(np.float32)


def outside(want, got, tol=TOL, bf16=False):
    """Elements of ``got`` outside ``tol`` (atol = rtol) of ``want`` (plus
    one bf16 rounding step when ``bf16``)."""
    a, b = _f32(want), _f32(got)
    rtol = tol + (BF16_RTOL if bf16 else 0.0)
    return np.abs(a - b) > tol + rtol * np.abs(a)


def assert_tree_close(want_tree, got_tree, tol=TOL, loose=lambda path: False,
                      loose_frac=0.005, loose_abs=0.05):
    """Every leaf of the port's tree against the reference's, in order,
    shapes and dtypes equal.  A leaf for which ``loose(path)`` holds may
    have up to max(2, ``loose_frac`` of its elements) outside ``tol`` (one
    bf16 rounding step more for a bf16 leaf), all within ``loose_abs``."""
    want = named_leaves(want_tree)
    got = flatten(got_tree)[0]
    assert len(want) == len(got), (len(want), len(got))
    for (path, a), b in zip(want, got):
        assert tuple(a.shape) == tuple(b.shape), (path, a.shape, b.shape)
        bf16 = a.dtype.name == "bfloat16"
        assert (b.dtype == torch.bfloat16) == bf16, (path, a.dtype, b.dtype)
        bad = outside(a, b, tol, bf16)
        if not loose(path):
            assert not bad.any(), (path, int(bad.sum()),
                                   float(np.abs(_f32(a) - _f32(b)).max()))
            continue
        budget = max(2, int(loose_frac * a.size))
        assert int(bad.sum()) <= budget, (path, int(bad.sum()), budget)
        assert np.abs(_f32(a) - _f32(b)).max() <= loose_abs, path


# --------------------------------------------------------------------------- #
# train steps in both packages                                                 #
# --------------------------------------------------------------------------- #
STEP_B, STEP_T, STEPS = 4, 32, 3
OPT = dict(lr=1e-3, warmup_steps=2, total_steps=30)
METRICS = ("loss", "xent", "aux", "mtp", "grad_norm", "lr")   # mtp: MTP configs


def run_both(arch, microbatches, factored, compress, steps=STEPS):
    """``steps`` train steps of the family in both packages from the same
    weights on the same tokens (and frontend inputs,
    :func:`frontend_inputs`): (reference metrics, reference state, port
    metrics, port state); the reference's step under ``jax.jit``."""
    from repro.train import optimizer as jopt
    from repro.train import trainer as jtr

    from repro_torch.train import optimizer, trainer
    from repro_torch.train.tree import tree_map

    cfg, tree, pcfg, params = model(arch)
    jstep = jax.jit(jtr.make_train_step(
        cfg, jopt.OptConfig(factored=factored, **OPT),
        microbatches=microbatches, compress_grads=compress))
    tstep = trainer.make_train_step(
        pcfg, optimizer.OptConfig(factored=factored, **OPT),
        microbatches=microbatches, compress_grads=compress)
    jp = jax_tree(tree)
    js = jtr.TrainState(jp, jopt.init_opt_state(jp, factored),
                        jax.tree.map(jnp.zeros_like, jp) if compress
                        else None)
    ts = trainer.TrainState(params, optimizer.init_opt_state(params, factored),
                            tree_map(torch.zeros_like, params) if compress
                            else None)
    jm, tm = [], []
    for i in range(steps):
        toks = tokens(10 + i, (STEP_B, STEP_T), cfg.vocab)
        extra = frontend_inputs(cfg, STEP_B, STEP_T, seed=20 + i)
        js, m = jstep(js, {"tokens": jnp.asarray(toks),
                           **{k: jnp.asarray(v) for k, v in extra.items()}})
        jm.append({k: float(m[k]) for k in METRICS if k in m})
        ts, m = tstep(ts, {"tokens": torch.from_numpy(toks).long(),
                           **{k: torch.from_numpy(v)
                              for k, v in extra.items()}})
        tm.append({k: float(m[k]) for k in METRICS if k in m})
    return jm, js, tm, ts


def check_step_run(jm, js, tm, ts, factored, compress):
    """Metrics of every step and every leaf of the final state within
    1e-4.  Two kinds of leaf are held looser (``assert_tree_close``'s
    budget), for reasons of arithmetic, not of the algorithm:

    * Adafactor's bf16 first moment: the update divided by the RMS of its
      row and column, so the gradients' float noise is magnified in rows
      whose gradients are small, then rounded to bf16;
    * every leaf of a compressed run: an element of g + e that lies at a
      rounding boundary of the int8 grid may go to the neighbouring level
      on one side (its carried error then moves by one quantization step,
      and its update with it).
    """
    for a, b in zip(jm, tm):
        assert set(a) == set(b)
        for k in a:
            np.testing.assert_allclose(b[k], a[k], rtol=TOL, atol=TOL,
                                       err_msg=k)
    assert_tree_close(js, ts, loose=lambda path: compress or (
        factored and path.startswith(".opt.mu")))
