"""The MoE layer (``repro_torch.models.moe``) against the JAX package's on
the CPU.

The reduced ``qwen2-moe-a2.7b`` (4 experts top-2, a gated shared expert)
and ``deepseek-v3-671b`` (4 experts top-2, an ungated shared expert) run
the reference's ``moe_init`` weights, their zero norm weight replaced by
seeded noise, through both packages' ``moe_apply`` on the same seeded
inputs: at capacity factors 0.1 (most tokens dropped), 1.25 (the
configs' own; some dropped) and 8.0 (none dropped), with one routing group
and with four, and with 4 padded experts.  The output and the auxiliary
loss agree within atol = rtol = 1e-5 (the same arithmetic summed in
another order), and the gradients of both within 1e-4.  The port's own
invariants mirror the reference's model tests: grouping does not change
the output when no token is dropped, and padded experts get zero
probability.
"""
import dataclasses

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402

from repro_torch import configs  # noqa: E402
from repro_torch.models import moe  # noqa: E402

ARCHS = ("qwen2-moe-a2.7b", "deepseek-v3-671b")
TOL = 1e-5
GRAD_TOL = 1e-4
B, T = 2, 12


def _cfgs(arch, **change):
    return (dataclasses.replace(jconfigs.get_reduced(arch), **change),
            dataclasses.replace(configs.get_reduced(arch), **change))


def _weights(cfg, seed=0):
    """The reference's ``moe_init`` as numpy, its zero norm weight replaced
    by seeded noise of scale 0.1."""
    p, _ = jmoe.moe_init(jax.random.PRNGKey(seed), cfg)
    p = {k: np.array(v) for k, v in p.items()}
    p["ln"] = (0.1 * np.random.default_rng(seed).standard_normal(
        p["ln"].shape)).astype(np.float32)
    return p


def _x(cfg, seed=1):
    return np.random.default_rng(seed).standard_normal(
        (B, T, cfg.d_model)).astype(np.float32)


@pytest.fixture
def groups():
    """Set both packages' routing groups; back to 1 afterwards."""
    def set_both(g):
        jmoe.set_groups(g)
        moe.set_groups(g)
    yield set_both
    set_both(1)


def _both(jcfg, tcfg, p, x):
    jy, jaux = jax.jit(lambda p_, x_: jmoe.moe_apply(jcfg, p_, x_))(
        {k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x))
    ty, taux = moe.moe_apply(tcfg, {k: torch.from_numpy(v)
                                    for k, v in p.items()},
                             torch.from_numpy(x))
    return (np.asarray(jy), float(jaux)), (ty.numpy(), float(taux))


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=tol,
                               rtol=tol)


@pytest.mark.parametrize("n_groups", [1, 4])
@pytest.mark.parametrize("cf", [0.1, 1.25, 8.0])
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_apply_matches_jax(arch, cf, n_groups, groups):
    jcfg, tcfg = _cfgs(arch, capacity_factor=cf)
    groups(n_groups)
    p = _weights(jcfg)
    (jy, jaux), (ty, taux) = _both(jcfg, tcfg, p, _x(jcfg))
    _close(ty, jy)
    _close(taux, jaux)
    assert taux > 0.0


@pytest.mark.parametrize("arch", ARCHS)
def test_padded_experts_match_jax_and_get_no_probability(arch):
    jcfg, tcfg = _cfgs(arch, n_experts_pad=4)
    p = _weights(jcfg)
    assert p["wg"].shape[0] == p["router"].shape[1] == 8
    x = _x(jcfg)
    (jy, jaux), (ty, taux) = _both(jcfg, tcfg, p, x)
    _close(ty, jy)
    _close(taux, jaux)
    _, logits, probs = moe.router_probs(
        tcfg, {k: torch.from_numpy(v) for k, v in p.items()},
        torch.from_numpy(x))
    assert bool((logits[:, 4:] == -1e9).all())
    assert bool((probs[:, 4:] == 0.0).all())
    np.testing.assert_allclose(probs.sum(-1).numpy(), 1.0, rtol=1e-6)


@pytest.mark.parametrize("arch", ARCHS)
def test_grouping_is_invariant_without_drops(arch, groups):
    """At capacity factor 8 no token is dropped, so routing per group of 6
    tokens equals routing all 24 at once (the reference's invariant)."""
    _, tcfg = _cfgs(arch, capacity_factor=8.0)
    p = {k: torch.from_numpy(v) for k, v in _weights(tcfg).items()}
    x = torch.from_numpy(_x(tcfg))
    y1, a1 = moe.moe_apply(tcfg, p, x)
    groups(4)
    assert moe.get_groups() == 4
    y4, a4 = moe.moe_apply(tcfg, p, x)
    _close(y4.numpy(), y1.numpy())
    assert float(a4) == float(a1)     # the aux loss ignores the groups


@pytest.mark.parametrize("arch", ARCHS)
def test_gradients_match_jax(arch):
    """d(sum of y * seeded weights + aux) / d(params, x) in both packages
    at the configs' own capacity factor (some tokens dropped)."""
    jcfg, tcfg = _cfgs(arch)
    p = _weights(jcfg)
    x = _x(jcfg)
    r = np.random.default_rng(2).standard_normal(x.shape).astype(np.float32)

    def jloss(p_, x_):
        y, aux = jmoe.moe_apply(jcfg, p_, x_)
        return jnp.sum(y * jnp.asarray(r)) + aux
    jg_p, jg_x = jax.jit(jax.grad(jloss, argnums=(0, 1)))(
        {k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x))
    tp = {k: torch.from_numpy(v).requires_grad_(True) for k, v in p.items()}
    tx = torch.from_numpy(x).requires_grad_(True)
    y, aux = moe.moe_apply(tcfg, tp, tx)
    loss = (y * torch.from_numpy(r)).sum() + aux
    grads = torch.autograd.grad(loss, [tx] + [tp[k] for k in sorted(tp)])
    _close(grads[0].numpy(), np.asarray(jg_x), GRAD_TOL)
    for k, g in zip(sorted(tp), grads[1:]):
        np.testing.assert_allclose(g.numpy(), np.asarray(jg_p[k]),
                                   atol=GRAD_TOL, rtol=GRAD_TOL, err_msg=k)


@pytest.mark.parametrize("cf,Tg,k,n,want", [
    (1.25, 4, 4, 60, 1),       # Qwen1.5-MoE's 4-slot decode step drops
    (1.25, 1540, 4, 60, 129),
    (1.25, 4, 8, 256, 1),      # DeepSeek-V3's decode step
    (0.1, 24, 2, 4, 2), (8.0, 6, 2, 4, 24)])
def test_capacity_counts_the_real_experts(cf, Tg, k, n, want):
    for pad in (0, 4):
        cfg = dataclasses.replace(configs.get_reduced("qwen2-moe-a2.7b"),
                                  capacity_factor=cf, top_k=k, n_experts=n,
                                  n_experts_pad=pad)
        assert moe.capacity(cfg, Tg) == want


def test_dropped_tokens_keep_only_the_shared_output():
    """At capacity factor 0.1 each expert keeps C = 2 of the 24 tokens'
    picks: a token whose every pick was dropped gets the shared experts'
    output alone, as in the reference (checked against it above)."""
    jcfg, tcfg = _cfgs("deepseek-v3-671b", capacity_factor=0.1)
    p = {k: torch.from_numpy(v) for k, v in _weights(jcfg).items()}
    x = torch.from_numpy(_x(jcfg))
    y, _ = moe.moe_apply(tcfg, p, x)
    rows, _, _ = moe.router_probs(tcfg, p, x)
    shared = (torch.nn.functional.silu(rows @ p["swg"])
              * (rows @ p["swu"])) @ p["swd"]
    only_shared = torch.isclose(
        (y - x).reshape(-1, tcfg.d_model), shared, atol=1e-6,
        rtol=1e-6).all(-1)
    # 4 experts x 2 slots keep at most 8 of 48 picks: 16+ tokens lose both
    assert int(only_shared.sum()) >= B * T - 8
