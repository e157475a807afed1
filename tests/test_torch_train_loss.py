"""The training loss of the port against the JAX package on the CPU:
``_xent`` and ``lm_loss`` with their gradients, for every ported family.

Each reduced config (``train_compare.model``) runs in both packages with
the same weights and tokens.  The JAX side runs twice: with its default
kernel backend (the jnp oracles) and with ``ops.set_backend("pallas")``,
its Pallas kernels in interpret mode with the ``custom_vjp`` oracle
backward, as ``tests/test_kernels.py`` runs them; the backend is restored
afterwards.  The port runs its plain versions (CPU tensors), with and
without remat.  Tolerance: atol = rtol = 1e-4 on the loss and on every
gradient leaf (fp32; the same arithmetic summed in other orders).

Also here: the kernels' ``torch.autograd.Function`` (forward the kernel,
backward autograd of the plain version), driven on the CPU with the CUDA
wrappers replaced by their plain versions: its gradients equal autograd
of the plain version, and only forward launches are counted.
"""
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro.models import backbone as jbb  # noqa: E402

from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels.flash_attention import flash_attention_plain  # noqa: E402
from repro_torch.kernels.rglru_scan import linear_recurrence_plain  # noqa: E402
from repro_torch.kernels.rwkv6_scan import wkv6_plain  # noqa: E402
from repro_torch.models import backbone  # noqa: E402
from repro_torch.train.tree import flatten, unflatten  # noqa: E402

from train_compare import (FAMILIES, TOL, assert_tree_close,  # noqa: E402
                           jax_tree, model, tokens)

B, T = 2, 48
_REF = {}


def _reference(arch, backend):
    """The reference's (loss, xent, grads) of the family, once per
    backend."""
    if (arch, backend) not in _REF:
        cfg, tree, _, _ = model(arch)
        toks = jnp.asarray(tokens(1, (B, T), cfg.vocab))

        def f(p):
            loss, m = jbb.lm_loss(cfg, p, {"tokens": toks})
            return loss, m["xent"]
        jops.set_backend(backend)
        try:
            (loss, xent), g = jax.jit(jax.value_and_grad(f, has_aux=True))(
                jax_tree(tree))
        finally:
            jops.set_backend("ref")
        _REF[(arch, backend)] = (float(loss), float(xent), g)
    return _REF[(arch, backend)]


def _port(arch, remat):
    _, _, pcfg, params = model(arch)
    flat, s = flatten(params)
    xs = [p.detach().requires_grad_(True) for p in flat]
    toks = torch.from_numpy(tokens(1, (B, T), pcfg.vocab)).long()
    loss, metrics = backbone.lm_loss(pcfg, unflatten(s, xs),
                                     {"tokens": toks}, remat=remat)
    grads = torch.autograd.grad(loss, xs)
    metrics = {k: v.detach() for k, v in metrics.items()}
    return loss.detach(), metrics, unflatten(s, list(grads))


@pytest.mark.parametrize("backend", ["ref", "pallas"])
@pytest.mark.parametrize("arch", FAMILIES)
def test_lm_loss_and_grads_equal_the_reference(arch, backend):
    want_loss, want_xent, want_grads = _reference(arch, backend)
    loss, metrics, grads = _port(arch, remat=True)
    np.testing.assert_allclose(float(loss), want_loss, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(float(metrics["xent"]), want_xent, rtol=TOL,
                               atol=TOL)
    assert metrics["aux"].dtype == torch.float32 and metrics["aux"].dim() == 0
    assert float(metrics["aux"]) == 0.0
    assert_tree_close(want_grads, grads)


@pytest.mark.parametrize("arch", ["smollm-360m", "recurrentgemma-2b",
                                  "rwkv6-7b"])
def test_remat_changes_nothing(arch):
    """Recomputing each layer in the backward gives the same loss and
    gradients, bit for bit on the CPU."""
    l1, _, g1 = _port(arch, remat=True)
    l2, _, g2 = _port(arch, remat=False)
    assert float(l1) == float(l2)
    for a, b in zip(flatten(g1)[0], flatten(g2)[0]):
        assert torch.equal(a, b)


def test_xent_with_a_mask_equals_the_reference():
    rng = np.random.default_rng(3)
    logits = rng.standard_normal((2, 9, 40)).astype(np.float32) * 3
    labels = rng.integers(0, 40, size=(2, 9)).astype(np.int32)
    mask = (rng.random((2, 9)) > 0.3).astype(np.float32)
    for m in (None, mask, np.zeros_like(mask)):
        want, want_g = jax.value_and_grad(
            lambda x: jbb._xent(x, jnp.asarray(labels),
                                None if m is None else jnp.asarray(m)))(
            jnp.asarray(logits))
        x = torch.from_numpy(logits).requires_grad_(True)
        got = backbone._xent(x, torch.from_numpy(labels),
                             None if m is None else torch.from_numpy(m))
        (g,) = torch.autograd.grad(got, x)
        np.testing.assert_allclose(float(got), float(want), rtol=TOL,
                                   atol=TOL)
        np.testing.assert_allclose(g.numpy(), np.asarray(want_g), rtol=TOL,
                                   atol=TOL)


def test_lm_loss_refuses_the_families_still_to_come():
    import dataclasses
    _, _, pcfg, params = model("smollm-360m")
    toks = {"tokens": torch.zeros((1, 4), dtype=torch.long)}
    for change in (dict(frontend="vision"), dict(encoder_layers=2)):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            backbone.lm_loss(dataclasses.replace(pcfg, **change), params,
                             toks)
    # MTP is served (test_torch_moe_family.py)
    backbone._check_served(dataclasses.replace(pcfg, mtp=True))


# --------------------------------------------------------------------------- #
# the kernels' autograd.Function                                               #
# --------------------------------------------------------------------------- #
@pytest.fixture
def kernels_on_cpu(monkeypatch):
    """``ops`` as on the card, each CUDA wrapper replaced by its plain
    version (``route=`` and ``state_out=`` taken and ignored)."""
    monkeypatch.setattr(ops, "_on_cuda", lambda t: True)
    monkeypatch.setattr(ops, "flash_attention_cuda", flash_attention_plain)
    monkeypatch.setattr(ops, "rglru_scan_cuda",
                        lambda a, b, h0: linear_recurrence_plain(a, b, h0))
    monkeypatch.setattr(ops, "wkv6_cuda",
                        lambda *a, state_out=None: wkv6_plain(*a))
    ops.reset_launches()
    yield
    ops.reset_launches()


def _inputs(seed, shapes):
    g = torch.Generator().manual_seed(seed)
    return [torch.randn(s, generator=g) for s in shapes]


@pytest.mark.parametrize("name", ["flash_attention", "rglru_scan", "wkv6"])
def test_autograd_function_backward_is_the_plain_versions(kernels_on_cpu,
                                                          name):
    if name == "flash_attention":
        xs = _inputs(0, [(2, 16, 4, 8), (2, 16, 2, 8), (2, 16, 2, 8)])
        call = lambda *a: ops.flash_attention(*a, window=6)  # noqa: E731
        plain = lambda *a: flash_attention_plain(*a, window=6)  # noqa: E731
    elif name == "rglru_scan":
        a, b, h0 = _inputs(1, [(2, 12, 8), (2, 12, 8), (2, 8)])
        xs = [torch.sigmoid(a), b, h0]
        call, plain = ops.linear_recurrence, linear_recurrence_plain
    else:
        r, k, v, w, u = _inputs(2, [(1, 10, 2, 4), (1, 10, 2, 4),
                                    (1, 10, 2, 4), (1, 10, 2, 4), (2, 4)])
        s0 = torch.zeros(1, 2, 4, 4)
        xs = [r, k, v, torch.sigmoid(w), u, s0]
        call, plain = ops.wkv6, wkv6_plain
    grads = []
    for fn in (call, plain):
        leaves = [x.clone().requires_grad_(x.dim() > 0 and i < 5)
                  for i, x in enumerate(xs)]
        out = fn(*leaves)
        y = out[0] if isinstance(out, tuple) else out
        weight = torch.linspace(-1, 1, y.numel()).reshape(y.shape)
        wanted = [x for x in leaves if x.requires_grad]
        grads.append(torch.autograd.grad((y * weight).sum(), wanted))
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    key = {"rglru_scan": "rglru_scan"}.get(name, name)
    assert ops.launches[key] == 1           # the forward alone


def test_training_step_launches_forward_and_remat_recompute(kernels_on_cpu):
    """On the card a layer's attention launches twice a step with remat
    (the forward and its recompute in the backward), once without."""
    _, _, pcfg, params = model("smollm-360m")
    toks = {"tokens": torch.from_numpy(tokens(1, (1, 16), pcfg.vocab)).long()}
    for remat, per_layer in ((True, 2), (False, 1)):
        ops.reset_launches()
        flat, s = flatten(params)
        xs = [p.detach().requires_grad_(True) for p in flat]
        loss, _ = backbone.lm_loss(pcfg, unflatten(s, xs), toks, remat=remat)
        torch.autograd.grad(loss, xs)
        assert ops.launches["flash_attention"] == per_layer * pcfg.n_layers
