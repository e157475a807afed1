"""The reference's keywords on the port's signatures, held against the
JAX package on the CPU from seeded numpy inputs.

* ``blocks.attn_apply(..., use_rope=False)`` skips RoPE as the reference's
  ``_qkv`` does: a prefill, then two decode steps at one position for
  every row and at per-request positions, on the reduced Llama-3-8B's
  first layer (fp32, the model tests' 1e-4);
* ``layers.decode_attention(..., ring=...)``, which the reference's body
  never reads: equal with and without it, and to the reference's (2e-5,
  its kernel tests' fp32 tolerance).

``launch.dryrun.input_specs_for(cfg, shape_name=...)`` is held beside the
reference's dry run, in ``tests/test_torch_dryrun.py``.
"""
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_reduced as jax_get_reduced  # noqa: E402
from repro.models import backbone as jbb  # noqa: E402
from repro.models import blocks as jblocks  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402

from repro_torch.configs import get_reduced  # noqa: E402
from repro_torch.models import blocks, layers  # noqa: E402
from repro_torch.models.convert import params_from_reference  # noqa: E402

ARCH = "llama3_8b"
TOL = 1e-4


@pytest.fixture(scope="module")
def layer():
    """The reduced config and its first attention layer in both packages."""
    cfg = jax_get_reduced(ARCH)
    jparams, _ = jbb.init_params(cfg, jax.random.PRNGKey(0))
    tree = jax.tree.map(np.asarray, jparams)
    params = params_from_reference(get_reduced(ARCH), tree, device="cpu")
    jp = jax.tree.map(lambda x: x[0], jparams["groups"][0]["mix"])
    return cfg, jp, params["layers"][0]["mix"]


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=tol,
                               rtol=tol)


@pytest.mark.parametrize("per_request", [False, True],
                         ids=["one_position", "per_request"])
def test_attn_apply_without_rope_matches_the_reference(layer, per_request):
    cfg, jp, tp = layer
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 12, cfg.d_model)).astype(np.float32)
    jc = jblocks.attn_cache(cfg, 2, 32, jnp.float32)
    tc = blocks.attn_cache(cfg, 2, 32, torch.float32, "cpu")
    jy, jc = jblocks.attn_apply(cfg, jp, jnp.asarray(x), "prefill", jc, 0,
                                use_rope=False)
    ty, tc = blocks.attn_apply(cfg, tp, torch.from_numpy(x), "prefill", tc,
                               0, use_rope=False)
    _close(ty, jy)
    _close(tc["k"], jc["k"])
    roped, _ = blocks.attn_apply(cfg, tp, torch.from_numpy(x), "prefill",
                                 None, 0)
    assert not torch.allclose(roped, ty, atol=TOL)     # the keyword matters
    pos = np.array([12, 9], np.int32) if per_request else 12
    for _ in range(2):
        x1 = rng.standard_normal((2, 1, cfg.d_model)).astype(np.float32)
        jpos = jnp.asarray(pos) if per_request else pos
        tpos = torch.from_numpy(pos.astype(np.int64)) if per_request else pos
        jy, jc = jblocks.attn_apply(cfg, jp, jnp.asarray(x1), "decode", jc,
                                    jpos, use_rope=False)
        ty, tc = blocks.attn_apply(cfg, tp, torch.from_numpy(x1), "decode",
                                   tc, tpos, use_rope=False)
        _close(ty, jy)
        _close(tc["k"], jc["k"])
        _close(tc["v"], jc["v"])
        pos = pos + 1


@pytest.mark.parametrize("lens", [[10, 31, 40], [5]], ids=["ring", "one"])
def test_decode_attention_takes_ring_and_ignores_it(lens):
    B = len(lens)
    rng = np.random.default_rng(len(lens))
    q = rng.standard_normal((B, 8, 16)).astype(np.float32)
    k = rng.standard_normal((B, 32, 2, 16)).astype(np.float32)
    v = rng.standard_normal((B, 32, 2, 16)).astype(np.float32)
    cur = np.array(lens, np.int32)
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    flat = layers.decode_attention(tq, tk, tv, torch.from_numpy(cur))
    ring = layers.decode_attention(tq, tk, tv, torch.from_numpy(cur),
                                   ring=True)
    assert torch.equal(flat, ring)
    want = jlayers.decode_attention(jnp.asarray(q), jnp.asarray(k),
                                    jnp.asarray(v), jnp.asarray(cur),
                                    ring=True)
    _close(ring, want, 2e-5)
