"""The MoE family (Qwen1.5-MoE-A2.7B, DeepSeek-V3) through the port's
backbone, against the JAX package on the CPU.

Each reduced config runs in both packages with the same weights: the
reference's ``init_params`` tree, its zero norm weights replaced by seeded
noise (``train_compare.model``), carried across by
``repro_torch.models.convert``.  Reduced ``qwen2-moe-a2.7b``: 2 MoE layers
(4 experts top-2, a gated shared expert); reduced ``deepseek-v3-671b``: 2
MLA layers, the first dense, the second MoE, and the MTP depth.  The JAX
side runs its default kernel backend (the jnp oracles), the port its plain
versions (CPU tensors).

Tolerances: ``lm_loss``, its ``xent``, ``aux`` and ``mtp`` and every
gradient leaf within atol = rtol = 1e-4 (``train_compare.TOL``, as
``test_torch_train_loss.py``); prefill logits and 8 greedy decode steps
over fp32 caches within 2e-3 with equal greedy tokens (as
``test_torch_dense.py``); the server's greedy tokens equal, request for
request.
"""
import dataclasses

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.models import backbone as jbb  # noqa: E402
from repro.models.config import layer_groups as jlayer_groups  # noqa: E402
from repro.models.config import layer_plan as jlayer_plan  # noqa: E402
from repro.train.serve import BatchedServer as JaxServer  # noqa: E402
from repro.train.serve import Request as JaxRequest  # noqa: E402
from repro.train.serve import ServeConfig as JaxServeConfig  # noqa: E402

from repro_torch import configs  # noqa: E402
from repro_torch.launch.serve import main as serve_main  # noqa: E402
from repro_torch.models import backbone  # noqa: E402
from repro_torch.models.config import layer_groups, layer_plan  # noqa: E402
from repro_torch.models.convert import (  # noqa: E402
    grouped_params_from_reference, params_from_reference)
from repro_torch.train.serve import (BatchedServer, Request,  # noqa: E402
                                     ServeConfig)
from repro_torch.train.tree import flatten, unflatten  # noqa: E402

from train_compare import (TOL, assert_tree_close, jax_tree,  # noqa: E402
                           model, tokens)

ARCHS = ("qwen2-moe-a2.7b", "deepseek-v3-671b")
LOGIT_TOL = 2e-3
STEPS = 8


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), atol=tol,
                               rtol=tol)


def _serving(arch):
    """(reference config, reference params, port config, port params in
    the serving layout)."""
    cfg, tree, pcfg, _ = model(arch)
    return cfg, jax_tree(tree), pcfg, params_from_reference(pcfg, tree,
                                                            device="cpu")


# --------------------------------------------------------------------------- #
# configs                                                                      #
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("arch", ARCHS)
def test_config_equals_the_reference_field_for_field(arch):
    asdict = dataclasses.asdict
    full, jfull = configs.get_config(arch), jconfigs.get_config(arch)
    assert asdict(full) == asdict(jfull)
    assert asdict(configs.get_reduced(arch)) == \
        asdict(jconfigs.get_reduced(arch))
    assert full.param_count() == jfull.param_count()
    assert full.active_param_count() == jfull.active_param_count()
    assert [asdict(b) for b in layer_plan(full)] == \
        [asdict(b) for b in jlayer_plan(jfull)]
    assert [(asdict(b), n) for b, n in layer_groups(full)] == \
        [(asdict(b), n) for b, n in jlayer_groups(jfull)]
    assert configs.shape_applicable(full, configs.SHAPES["long_500k"]) == \
        jconfigs.shape_applicable(jfull, jconfigs.SHAPES["long_500k"])


def test_full_configs_are_the_published_ones():
    q, d = configs.get_config("qwen2-moe-a2.7b"), configs.get_config(
        "deepseek-v3-671b")
    assert (q.n_layers, q.n_experts, q.top_k, q.d_shared, q.shared_gate) == \
        (24, 60, 4, 5632, True)
    assert q.param_count() == jconfigs.get_config(
        "qwen2-moe-a2.7b").param_count() == 14_315_487_232
    plan = layer_plan(d)
    assert len(plan) == 61 and all(b.kind == "mla" for b in plan)
    assert [b.mlp for b in plan[:4]] == ["dense"] * 3 + ["moe"]
    assert (d.kv_lora_rank, d.qk_nope_head_dim + d.qk_rope_head_dim,
            d.v_head_dim, d.mtp) == (512, 192, 128, True)


def test_the_registry_serves_the_family_and_refuses_the_rest():
    """The family first, as in the reference; every reference arch
    resolves (the encoder-decoder and the vision stub too), and only
    unknown names are refused."""
    assert configs.ARCHS[:2] == ("qwen2_moe_a2_7b", "deepseek_v3_671b")
    assert configs.ARCHS == jconfigs.ARCHS
    assert configs.get_config("qwen2_moe_a2_7b").name == "qwen2-moe-a2.7b"
    for name in ("whisper-large-v3", "internvl2-76b"):
        assert dataclasses.asdict(configs.get_config(name)) == \
            dataclasses.asdict(jconfigs.get_config(name))
    with pytest.raises(KeyError, match="unknown arch"):
        configs.get_config("mixtral-8x7b")


# --------------------------------------------------------------------------- #
# parameters                                                                   #
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("arch", ARCHS)
def test_port_init_has_the_reference_shapes(arch):
    """The port's own init (serving layout, then the training layout)
    against the reference's tree carried across: the same leaves."""
    cfg, jparams, pcfg, converted = _serving(arch)
    own = backbone.init_params(pcfg, torch.Generator().manual_seed(0),
                               device="cpu")
    shapes = jax.tree.map(lambda t: tuple(t.shape), own)
    assert shapes == jax.tree.map(lambda t: tuple(t.shape), converted)
    assert ("mtp" in own) == cfg.mtp
    grouped = backbone.group_params(pcfg, own)
    want = jax.tree.map(lambda a: tuple(a.shape), jparams)
    assert jax.tree.map(lambda t: tuple(t.shape), grouped) == want


def test_convert_carries_mtp_in_both_layouts():
    cfg, tree, pcfg, grouped = model("deepseek-v3-671b")
    serving = params_from_reference(pcfg, tree, device="cpu")
    assert set(tree["mtp"]) == {"proj", "ln_h", "ln_e", "block"}
    for params in (serving, grouped):
        got, _ = flatten(params["mtp"])
        want = jax.tree.leaves(tree["mtp"])
        assert len(got) == len(want) > 4
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    again = grouped_params_from_reference(pcfg, tree, device="cpu")
    assert set(again) == set(tree) == {"embed", "groups", "final_norm",
                                       "head", "mtp"}


# --------------------------------------------------------------------------- #
# the training loss                                                            #
# --------------------------------------------------------------------------- #
B, T = 2, 24


@pytest.mark.parametrize("arch", ARCHS)
def test_lm_loss_metrics_and_grads_equal_the_reference(arch):
    cfg, tree, pcfg, params = model(arch)
    toks = tokens(1, (B, T), cfg.vocab)

    def f(p):
        return jbb.lm_loss(cfg, p, {"tokens": jnp.asarray(toks)})
    (jloss, jm), jg = jax.jit(jax.value_and_grad(f, has_aux=True))(
        jax_tree(tree))
    flat, s = flatten(params)
    xs = [p.detach().requires_grad_(True) for p in flat]
    loss, m = backbone.lm_loss(pcfg, unflatten(s, xs),
                               {"tokens": torch.from_numpy(toks).long()})
    grads = torch.autograd.grad(loss, xs)
    loss, m = loss.detach(), {k: v.detach() for k, v in m.items()}
    assert set(m) == set(jm) == ({"xent", "aux", "mtp"} if cfg.mtp
                                 else {"xent", "aux"})
    _close(float(loss), float(jloss), TOL)
    for k in jm:
        _close(float(m[k]), float(jm[k]), TOL)
    assert float(m["aux"]) > 0.0
    want = float(m["xent"]) + float(m["aux"]) + (
        cfg.mtp_coef * float(m["mtp"]) if cfg.mtp else 0.0)
    _close(float(loss), want, 1e-6)
    assert_tree_close(jg, unflatten(s, list(grads)))


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_returns_the_aux_loss(arch):
    """``forward`` returns (h, caches, aux) as the reference's; aux sums
    the MoE layers' losses, and is a 0-d fp32 zero for a dense stack."""
    cfg, jparams, pcfg, params = _serving(arch)
    toks = tokens(2, (1, 10), cfg.vocab)
    jh = jbb.embed_tokens(cfg, jparams, jnp.asarray(toks))
    _, _, jaux = jax.jit(lambda p, h: jbb.forward(cfg, p, h, "train"))(
        jparams, jh)
    h = backbone.embed_tokens(pcfg, params, torch.from_numpy(toks).long())
    out = backbone.forward(pcfg, params, h, "train")
    assert len(out) == 3 and out[2].dim() == 0
    _close(float(out[2]), float(jaux), TOL)
    dense = dataclasses.replace(pcfg, n_experts=0, first_dense=0, mtp=False)
    dparams = backbone.init_params(dense, torch.Generator().manual_seed(1),
                                   device="cpu")
    _, _, aux = backbone.forward(dense, dparams, backbone.embed_tokens(
        dense, dparams, torch.from_numpy(toks).long()), "train")
    assert aux.dtype == torch.float32 and float(aux) == 0.0


# --------------------------------------------------------------------------- #
# serving                                                                      #
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_greedy_decode_match_jax(arch):
    cfg, jparams, pcfg, params = _serving(arch)
    toks = tokens(3, (2, 12), cfg.vocab)
    Tp, S = toks.shape[1], 32
    jc = jbb.init_cache(cfg, 2, S, dtype=jnp.float32)
    tc = backbone.init_cache(pcfg, 2, S, dtype=torch.float32, device="cpu")
    jl, jc = jax.jit(lambda p, t, c: jbb.prefill(cfg, p, {"tokens": t}, c))(
        jparams, jnp.asarray(toks), jc)
    tl, tc = backbone.prefill(pcfg, params,
                              {"tokens": torch.from_numpy(toks).long()}, tc)
    jdec = jax.jit(lambda p, t, c, pos: jbb.decode_step(cfg, p, t, c, pos))
    _close(tl, jl, LOGIT_TOL)
    for i in range(STEPS):
        jt = jnp.argmax(jl, axis=-1).astype(jnp.int32)
        tt = torch.argmax(tl, dim=-1)
        assert tt.tolist() == np.asarray(jt).tolist()
        jl, jc = jdec(jparams, jt, jc, jnp.int32(Tp + i))
        tl, tc = backbone.decode_step(pcfg, params, tt, tc, Tp + i)
        _close(tl, jl, LOGIT_TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_continues_the_dense_forward(arch):
    """With an ample capacity factor (no token dropped, so routing does
    not depend on how many tokens compete) and fp32 caches, prefill then
    decode equals the forward over the whole sequence, as the reference's
    invariant (``tests/test_models.py``)."""
    _, _, pcfg, params = _serving(arch)
    pcfg = dataclasses.replace(pcfg, capacity_factor=8.0)
    S = 12
    toks = torch.from_numpy(tokens(7, (1, S + 1), pcfg.vocab)).long()
    hf, _, _ = backbone.forward(pcfg, params, backbone.embed_tokens(
        pcfg, params, toks), "train")
    caches = backbone.init_cache(pcfg, 1, 32, dtype=torch.float32,
                                 device="cpu")
    pre, caches = backbone.prefill(pcfg, params, {"tokens": toks[:, :S]},
                                   caches)
    _close(pre, backbone.logits_fn(pcfg, params, hf[:, S - 1]), LOGIT_TOL)
    dec, _ = backbone.decode_step(pcfg, params, toks[:, S], caches, S)
    _close(dec, backbone.logits_fn(pcfg, params, hf[:, S]), LOGIT_TOL)


@pytest.mark.parametrize("arch,cache", [
    ("qwen2-moe-a2.7b", "bfloat16"), ("qwen2-moe-a2.7b", "float32"),
    ("deepseek-v3-671b", "bfloat16"), ("deepseek-v3-671b", "float32")])
def test_batched_server_matches_jax_greedy(arch, cache):
    """Five requests through two slots (slots reused, the queue FCFS),
    fp32 parameters, the servers' default bf16 cache or an fp32 one:
    identical greedy tokens, request for request.  As in the reference,
    each decode step routes every slot's token, an idle slot's included,
    with the capacity of that call."""
    cfg, jparams, pcfg, params = _serving(arch)
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


def test_the_serving_launcher_serves_qwen_moe_on_the_cpu(capsys):
    assert serve_main(["--arch", "qwen2-moe-a2.7b", "--reduced",
                       "--device", "cpu", "--requests", "3", "--slots", "2",
                       "--cache-len", "32", "--max-new", "3"]) == 0
    assert "[serve] 3/3 requests" in capsys.readouterr().out
