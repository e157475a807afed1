"""The port's mesh, sharding plan, logical axes and shapes against the JAX
package's (``repro.launch.mesh`` / ``shardings``, ``models.backbone``
``param_axes`` / ``param_shapes`` / ``cache_shapes``, ``train.optimizer``
``opt_axes``).

The reference side uses ``jax.sharding.AbstractMesh``, as
``tests/test_shardings.py`` does; the port's ``Mesh`` is its layout only.
A ``PartitionSpec`` is read as a tuple.  Shapes are at full size: the
port's on ``meta``, the reference's from ``jax.eval_shape``.
"""
import itertools

import jax
import jax.numpy as jnp
import pytest
import torch
from jax.sharding import AbstractMesh, PartitionSpec as P

from repro.configs import ARCHS, get_config as ref_config
from repro.launch import shardings as ref_sh
from repro.launch.mesh import dp_axes as ref_dp_axes, dp_size as ref_dp_size
from repro.models import backbone as ref_bb
from repro.train import optimizer as ref_opt
from repro.train.trainer import TrainState as RefTrainState
from repro_torch.configs import get_config
from repro_torch.launch import mesh as meshmod
from repro_torch.launch.shardings import device_bytes, is_spec, make_plan
from repro_torch.models import backbone
from repro_torch.train import optimizer
from repro_torch.train.trainer import TrainState
from repro_torch.train.tree import flatten

MESHES = {"single": ((16, 16), ("data", "model")),
          "multi": ((2, 16, 16), ("pod", "data", "model"))}
FLAGS = list(itertools.product((None, True, False), repeat=4))
CELLS = [(a, m) for a in ARCHS for m in MESHES]


def _ref_mesh(name):
    return AbstractMesh(*MESHES[name])


def _mesh(name):
    return meshmod.Mesh(MESHES[name][1], MESHES[name][0])


def _ref_specs(tree):
    return [tuple(s) for s in
            jax.tree.leaves(tree, is_leaf=lambda x: isinstance(x, P))]


def _specs(tree):
    return flatten(tree, is_spec)[0]


def _is_axes(x):
    return isinstance(x, tuple) and all(a is None or isinstance(a, str)
                                        for a in x)


def _pairs(arch, mesh, fsdp=None, ep=None, ep2=None, sp=True):
    kw = dict(fsdp=fsdp, ep=ep, ep2=ep2, sp=sp)
    return (ref_sh.make_plan(ref_config(arch), _ref_mesh(mesh), **kw),
            make_plan(get_config(arch), _mesh(mesh), **kw))


def _opt_state_ref(shapes, factored):
    return jax.eval_shape(lambda: ref_opt.init_opt_state(shapes, factored))


# --------------------------------------------------------------------------- #
# the plan, leaf for leaf                                                      #
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("arch,mesh", CELLS)
def test_plan_rules_and_flag_driven_specs_equal_the_reference(
        arch, mesh, monkeypatch):
    """Every combination of fsdp / ep / ep2 / sp in {None, True, False}:
    the rules, the resolved flags, the parameter specs, the activation and
    dispatch specs and the routing groups.  (The reference's axes, which
    its plan traces anew for every spec tree, are traced once here.)"""
    axes = ref_bb.param_axes(ref_config(arch))
    monkeypatch.setattr(ref_sh.backbone, "param_axes", lambda cfg: axes)
    for fsdp, ep, ep2, sp in FLAGS:
        ref, port = _pairs(arch, mesh, fsdp, ep, ep2,
                           True if sp is None else sp)
        got = (port.rules, port.fsdp, port.ep, port.ep2, port.sp, port.dp)
        want = (ref.rules, ref.fsdp, ref.ep, ref.ep2, ref.sp, ref.dp)
        assert got == want, (fsdp, ep, ep2, sp)
        assert _specs(port.param_specs()) == _ref_specs(ref.param_specs())
        ra, re_ = ref.act_spec(), ref.ep_spec()
        assert port.act_spec() == (None if ra is None else tuple(ra))
        assert port.ep_spec() == (None if re_ is None else tuple(re_))
        assert port.moe_groups() == ref.moe_groups()


@pytest.mark.parametrize("arch,mesh", CELLS)
def test_state_batch_and_cache_specs_equal_the_reference(arch, mesh):
    """ZeRO-1 moments and the whole train state (fsdp auto, on, off;
    factored or not), the batch of every shape, and the caches of each
    shape's batch and length."""
    rcfg, cfg = ref_config(arch), get_config(arch)
    rshapes = ref_bb.param_shapes(rcfg, dtype=jnp.bfloat16)
    shapes = backbone.param_shapes(cfg, torch.bfloat16)
    for fsdp in (None, True, False):
        ref, port = _pairs(arch, mesh, fsdp=fsdp)
        for factored in (False, True):
            rstate = RefTrainState(rshapes, _opt_state_ref(rshapes, factored),
                                   None)
            state = TrainState(shapes, optimizer.init_opt_state(
                shapes, factored), None)
            assert _specs(port.train_state_specs(state, factored)) == \
                _ref_specs(ref.train_state_specs(rstate, factored))
    ref, port = _pairs(arch, mesh)
    for B, T in ((256, 4096), (32, 32768), (128, 32768), (1, 524288)):
        rb = {"tokens": jax.ShapeDtypeStruct((B, T), jnp.int32),
              "enc_embeds": jax.ShapeDtypeStruct((B, 1500, 8), jnp.bfloat16)}
        pb = {"tokens": torch.empty((B, T), dtype=torch.int32, device="meta"),
              "enc_embeds": torch.empty((B, 1500, 8), device="meta")}
        want = {k: tuple(v) for k, v in ref.batch_specs(rb).items()}
        assert port.batch_specs(pb) == want
        S_enc = 1500 if rcfg.is_encdec else 0
        rc = ref_bb.cache_shapes(rcfg, B, T, S_enc=S_enc)
        pc = backbone.cache_shapes(cfg, B, T, S_enc=S_enc)
        assert _specs(port.cache_specs(pc)) == _ref_specs(ref.cache_specs(rc))


def test_local_shape_and_device_bytes():
    port = make_plan(get_config("llama3-8b"), _mesh("multi"))
    assert port.local_shape((64, 4096, 33), (("pod", "data"), "model")) \
        == (2, 256, 33)
    t = {"a": torch.empty((32, 16), dtype=torch.bfloat16, device="meta"),
         "b": torch.empty((), dtype=torch.int32, device="meta")}
    assert device_bytes(port, t, {"a": ("data", "model"), "b": ()}) == \
        2 * 1 * 2 + 4


# --------------------------------------------------------------------------- #
# axes and shapes                                                              #
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("arch", ARCHS)
def test_param_axes_and_shapes_equal_the_reference(arch):
    rcfg, cfg = ref_config(arch), get_config(arch)
    ra = ref_bb.param_axes(rcfg)
    pa = backbone.param_axes(cfg)
    fa, ra_def = jax.tree.flatten(ra, is_leaf=_is_axes)
    assert flatten(pa, _is_axes)[0] == fa
    for dtype, rdtype in ((torch.float32, jnp.float32),
                          (torch.bfloat16, jnp.bfloat16)):
        rs = jax.tree.leaves(ref_bb.param_shapes(rcfg, dtype=rdtype))
        ps = flatten(backbone.param_shapes(cfg, dtype))[0]
        assert [tuple(t.shape) for t in ps] == [s.shape for s in rs]
        assert all(t.device.type == "meta" and t.dtype == dtype for t in ps)
        assert all(s.dtype == rdtype for s in rs)


@pytest.mark.parametrize("arch", ARCHS)
def test_cache_shapes_equal_the_reference(arch):
    """Every cache leaf's shape and dtype, bf16 and int8 (the int8 layout
    for attention KV only), stacked (count, ...) a group."""
    rcfg, cfg = ref_config(arch), get_config(arch)
    S_enc = 1500 if rcfg.is_encdec else 0
    for rdt, dt in ((jnp.bfloat16, torch.bfloat16), (jnp.int8, torch.int8)):
        rc = jax.tree.leaves(ref_bb.cache_shapes(rcfg, 4, 4096, S_enc=S_enc,
                                                 dtype=rdt))
        pc = flatten(backbone.cache_shapes(cfg, 4, 4096, S_enc=S_enc,
                                           dtype=dt))[0]
        assert [tuple(t.shape) for t in pc] == [s.shape for s in rc]
        assert [str(t.dtype).split(".")[-1] for t in pc] == \
            [str(s.dtype) for s in rc]


@pytest.mark.parametrize("arch", ARCHS)
def test_opt_axes_equal_the_reference(arch):
    rcfg, cfg = ref_config(arch), get_config(arch)
    rshapes = ref_bb.param_shapes(rcfg, dtype=jnp.bfloat16)
    shapes = backbone.param_shapes(cfg, torch.bfloat16)
    for factored in (False, True):
        want = jax.tree.leaves(ref_opt.opt_axes(ref_bb.param_axes(rcfg),
                                                rshapes, factored),
                               is_leaf=_is_axes)
        got = flatten(optimizer.opt_axes(backbone.param_axes(cfg), shapes,
                                         factored), _is_axes)[0]
        assert got == want


# --------------------------------------------------------------------------- #
# the reference's sharding tests (tests/test_shardings.py) on the port        #
# --------------------------------------------------------------------------- #
def _mesh_axes_helpers():
    m = _mesh("multi")
    assert meshmod.dp_axes(m) == ("pod", "data") == ref_dp_axes(
        _ref_mesh("multi"))
    assert meshmod.dp_size(m) == 32 == ref_dp_size(_ref_mesh("multi"))
    assert meshmod.dp_size(_mesh("single")) == 16
    prod = meshmod.make_production_mesh()
    assert prod.shape == {"data": 16, "model": 16} and prod.size == 256
    assert meshmod.make_production_mesh(multi_pod=True).size == 512


def _rules_llama():
    plan = make_plan(get_config("llama3-8b"), _mesh("single"))
    r = plan.rules
    assert r["vocab"] == "model" and r["heads"] == "model"
    assert r["kv_heads"] is None and r["d_ff"] == "model"
    assert not plan.fsdp and not plan.ep


def _rules_divisibility_fallbacks():
    plan = make_plan(get_config("smollm-360m"), _mesh("single"))
    assert plan.rules["heads"] is None and plan.rules["d_ff"] == "model"
    wh = make_plan(get_config("whisper-large-v3"), _mesh("single"))
    assert wh.rules["vocab"] is None and wh.rules["heads"] is None


def _rules_moe_and_fsdp():
    ds = make_plan(get_config("deepseek-v3-671b"), _mesh("single"))
    assert ds.fsdp and ds.ep
    assert ds.rules["experts"] == "model" and ds.rules["d_expert"] is None
    assert ds.rules["d_model"] == "data"
    qw = make_plan(get_config("qwen2-moe-a2.7b"), _mesh("single"))
    assert not qw.ep and qw.rules["d_expert"] == "model"
    assert qw.ep_spec() == ("data", None, None, None)
    assert ds.ep_spec() == ("data", "model", None, None)


def _param_specs_cover_every_leaf():
    for arch in ("llama3-8b", "deepseek-v3-671b", "rwkv6-7b",
                 "recurrentgemma-2b", "whisper-large-v3"):
        cfg = get_config(arch)
        plan = make_plan(cfg, _mesh("multi"))
        shapes = flatten(backbone.param_shapes(cfg, torch.bfloat16))[0]
        specs = _specs(plan.param_specs())
        assert len(shapes) == len(specs)
        for s, spec in zip(shapes, specs):
            assert len(spec) <= s.dim()
            for dim, ax in zip(s.shape, spec + (None,) * s.dim()):
                if ax == "model":
                    assert dim % 16 == 0, (arch, s.shape, spec)


def _zero1_moment_sharding():
    cfg = get_config("llama3-8b")
    plan = make_plan(cfg, _mesh("single"))
    shapes = backbone.param_shapes(cfg, torch.bfloat16)
    mspecs = _specs(plan.opt_moment_specs(shapes, plan.param_specs()))
    n_extra = 0
    for s, spec in zip(flatten(shapes)[0], mspecs):
        dims = spec + (None,) * (s.dim() - len(spec))
        n_extra += "data" in [d for d in dims if isinstance(d, str)]
        for dim, ax in zip(s.shape, dims):
            if ax == "data":
                assert dim % 16 == 0
    assert n_extra > 0       # ZeRO-1 actually engaged


def _cache_specs_shard_long_axes():
    cfg = get_config("llama3-8b")
    plan = make_plan(cfg, _mesh("single"))
    caches = backbone.cache_shapes(cfg, 128, 32768)
    for c, spec in zip(flatten(caches)[0], _specs(plan.cache_specs(caches))):
        if c.dim() == 5:      # (L, B, S, Hkv, hd)
            assert spec[1] == "data" and spec[2] == "model"


def _batch_specs_batch1_replicated():
    plan = make_plan(get_config("rwkv6-7b"), _mesh("single"))
    t = torch.empty((1, 524288), dtype=torch.int32, device="meta")
    assert plan.batch_specs({"tokens": t})["tokens"] == (None, None)
    t = torch.empty((256, 4096), dtype=torch.int32, device="meta")
    assert plan.batch_specs({"tokens": t})["tokens"] == ("data", None)


def _act_spec_sequence_parallel():
    plan = make_plan(get_config("llama3-8b"), _mesh("multi"))
    assert plan.act_spec() == (("pod", "data"), "model", None)
    assert make_plan(get_config("llama3-8b"), _mesh("single"),
                     sp=False).act_spec() is None


REFERENCE_CASES = {f.__name__[1:]: f for f in (
    _mesh_axes_helpers, _rules_llama, _rules_divisibility_fallbacks,
    _rules_moe_and_fsdp, _param_specs_cover_every_leaf,
    _zero1_moment_sharding, _cache_specs_shard_long_axes,
    _batch_specs_batch1_replicated, _act_spec_sequence_parallel)}


@pytest.mark.parametrize("name", list(REFERENCE_CASES))
def test_reference_sharding_case_holds_on_the_port(name):
    REFERENCE_CASES[name]()
