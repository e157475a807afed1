"""Logical-axis -> partition-spec rules for the production meshes (a port
of the JAX package's ``launch/shardings.py``).

The models annotate every parameter with logical axis names
(``backbone.param_axes``); this module maps those names onto a mesh.  The
same rules drive params, optimizer state (ZeRO-1), gradients, batches and
KV caches, so the whole (arch x shape x mesh) matrix is one table.

Baseline layout (Megatron-style TP + DP):

* ``model`` axis: tensor parallelism — vocab / heads / d_ff / d_expert /
  lru sharded when divisible, replicated otherwise (SmolLM's 15 heads,
  Whisper's 20 heads, 49155/51866 vocabs);
* ``data`` (+ ``pod``) axes: batch;
* FSDP (``fsdp=True``, default above 2e10 parameters): ``d_model``
  additionally sharded over ``data`` — ZeRO-3-style weight gathering;
* ZeRO-1 otherwise: optimizer moments get an extra ``data`` sharding on
  their first divisible replicated dim;
* EP (allocated experts divisible by ``model``): experts on ``model``
  (the all-to-all layout); TP over ``d_expert`` otherwise;
* SP: the residual stream between layers is sequence-sharded over
  ``model``.

A spec is a plain tuple with one entry a dimension: ``None``, a mesh axis
name, or a tuple of names (the reference's ``PartitionSpec``, read as a
tuple).  One card has no ``NamedSharding``: in place of ``Plan.shard``,
:meth:`Plan.local_shape` and :func:`device_bytes` give the shard a device
holds, which is what the dry run's memory counts.  The reference's
``set_act_spec`` / ``set_ep_spec`` hints steer only XLA's partitioner; the
port's dry run reads :meth:`Plan.act_spec` and :meth:`Plan.ep_spec`.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

from ..models import backbone
from ..models.config import ModelConfig
from ..train.optimizer import OptState, is_axes, opt_axes
from ..train.tree import flatten, leaves, tree_map
from . import mesh as meshmod
from .mesh import Mesh

__all__ = ["Plan", "make_plan", "device_bytes", "is_spec"]

Tree = Any
Spec = Tuple[Any, ...]


def is_spec(x) -> bool:
    """A leaf of a spec tree: a tuple of None, axis names and tuples of
    axis names."""
    return isinstance(x, tuple) and all(
        d is None or isinstance(d, str)
        or (isinstance(d, tuple) and all(isinstance(e, str) for e in d))
        for d in x)


def _axes_of(d) -> Tuple[str, ...]:
    if d is None:
        return ()
    return (d,) if isinstance(d, str) else tuple(d)


@dataclass(frozen=True)
class Plan:
    """Resolved layout decisions for one (arch, mesh)."""

    cfg: ModelConfig
    mesh: Mesh
    dp: Tuple[str, ...]
    fsdp: bool
    ep: bool
    sp: bool
    rules: Dict[str, Optional[str]]
    # EP over BOTH mesh axes (DeepSeek-style EP-256): expert weights become
    # fully device-local; the only expert collective left is the
    # dispatch/combine all-to-all.
    ep2: bool = False

    # ---- spec trees --------------------------------------------------------
    def param_specs(self) -> Tree:
        return tree_map(self._axes_to_spec, backbone.param_axes(self.cfg),
                        is_leaf=is_axes)

    def opt_moment_specs(self, param_shapes: Tree, param_specs: Tree) -> Tree:
        """ZeRO-1: moments inherit the param spec + an extra dp sharding on
        the first divisible, unsharded dim (no-op under FSDP, where d_model
        already carries ``data``)."""
        dsize = meshmod.dp_size(self.mesh)

        def f(shape, spec):
            dims = list(spec) + [None] * (len(shape.shape) - len(spec))
            if self.fsdp or dsize == 1:
                return tuple(dims)
            if "data" in {a for d in dims for a in _axes_of(d)}:
                return tuple(dims)
            for i, d in enumerate(dims):
                if d is None and shape.shape[i] % dsize == 0 \
                        and shape.shape[i] > 0:
                    dims[i] = "data"
                    break
            return tuple(dims)

        return tree_map(lambda spec, shape: f(shape, spec), param_specs,
                        param_shapes, is_leaf=is_spec)

    def train_state_specs(self, state, factored: bool):
        """Specs for a whole ``TrainState`` (params + optimizer moments)."""
        pspecs = self.param_specs()
        oax = opt_axes(backbone.param_axes(self.cfg), state.params, factored)
        mu = tree_map(self._axes_to_spec, oax.mu, is_leaf=is_axes)
        nu = tree_map(self._axes_to_spec, oax.nu, is_leaf=is_axes)
        return type(state)(
            params=pspecs,
            opt=OptState((), self.opt_moment_specs(state.opt.mu, mu),
                         self.opt_moment_specs(state.opt.nu, nu)),
            err=None)

    def _dp_entry(self):
        return self.dp if len(self.dp) > 1 else self.dp[0]

    def batch_specs(self, batch_shapes: Dict[str, Any]) -> Dict[str, Spec]:
        dp = self._dp_entry()

        def f(s):
            nd = len(s.shape)
            if s.shape[0] % max(1, meshmod.dp_size(self.mesh)) != 0:
                return (None,) * nd              # e.g. batch 1 (long_500k)
            return (dp,) + (None,) * (nd - 1)

        return {k: f(v) for k, v in batch_shapes.items()}

    def cache_specs(self, cache_shapes: Tree) -> Tree:
        """KV/state cache layout: batch on dp, long axes on ``model``.

        Leaves are keyed dicts inside the group list; shapes are
        (layer_count, B, ...).  Sequence axes are model-sharded (a
        partial-softmax reduction over ``model`` in decode)."""
        dp = self._dp_entry()
        msize = self.mesh.shape["model"]
        dsize = max(1, meshmod.dp_size(self.mesh))

        def leaf(key, s):
            nd = len(s.shape)
            b = dp if s.shape[1] % dsize == 0 else None
            if key in ("k", "v", "ks", "vs", "ckv", "kr", "ck", "cv"):
                seq = "model" if s.shape[2] % msize == 0 else None
                return (None, b, seq) + (None,) * (nd - 3)
            if key == "s":          # rwkv state (L, B, H, dk, dv)
                h = "model" if s.shape[2] % msize == 0 else None
                return (None, b, h) + (None,) * (nd - 3)
            if key == "h":          # rglru state (L, B, W)
                w = "model" if s.shape[2] % msize == 0 else None
                return (None, b, w)
            if key == "conv":       # (L, B, 3, W)
                w = "model" if s.shape[3] % msize == 0 else None
                return (None, b, None, w)
            return (None, b) + (None,) * (nd - 2)

        def walk(node, key=None):
            if isinstance(node, dict):
                return {k: walk(v, k) for k, v in node.items()}
            if isinstance(node, list):
                return [walk(v, key) for v in node]
            return leaf(key, node)

        return walk(cache_shapes)

    def act_spec(self) -> Optional[Spec]:
        """Residual-stream spec (B, T, D) under SP."""
        if not self.sp:
            return None
        return (self._dp_entry(), "model", None)

    def ep_spec(self) -> Optional[Spec]:
        """MoE dispatch-buffer spec (G, E, C, D): routing groups ride the
        data axes; experts ride ``model`` under EP, and both axes under
        ep2 (G then unsharded)."""
        if not self.cfg.n_experts:
            return None
        if self.ep2:
            return (None, tuple(self.dp) + ("model",), None, None)
        return (self._dp_entry(), "model" if self.ep else None, None, None)

    def moe_groups(self) -> int:
        """Routing groups = DP ranks (per-rank dispatch, as in real EP)."""
        return meshmod.dp_size(self.mesh) if self.cfg.n_experts else 1

    # ---- a device's shard -------------------------------------------------
    def local_shape(self, shape, spec: Spec) -> Tuple[int, ...]:
        """The shape of the shard one device holds of a ``shape`` array
        under ``spec``: each dimension divided by the sizes of its axes
        (rounded up, as an uneven split pads its last shard)."""
        out = []
        for i, n in enumerate(shape):
            k = 1
            for a in _axes_of(spec[i] if i < len(spec) else None):
                k *= self.mesh.shape[a]
            out.append(-(-n // k))
        return tuple(out)

    # ---- helpers ----------------------------------------------------------
    def _axes_to_spec(self, axes: Tuple[Optional[str], ...]) -> Spec:
        if self.ep2 and "experts" in axes:
            # expert tensors: E takes every mesh axis, other dims local
            return tuple(tuple(self.dp) + ("model",) if a == "experts"
                         else None for a in axes)
        return tuple(self.rules.get(a) if a else None for a in axes)


def device_bytes(plan: Plan, tree: Tree, specs: Tree) -> int:
    """Bytes one device holds of a tree of tensors under a matching spec
    tree (a leaf of ``specs`` may be ``()`` for a replicated scalar)."""
    flat = leaves(tree)
    spec_flat = flatten(specs, is_spec)[0]
    if len(flat) != len(spec_flat):
        raise ValueError(f"{len(flat)} leaves against {len(spec_flat)} "
                         "specs")
    total = 0
    for t, spec in zip(flat, spec_flat):
        n = 1
        for d in plan.local_shape(tuple(t.shape), spec):
            n *= d
        total += n * t.element_size()
    return total


def make_plan(cfg: ModelConfig, mesh: Mesh, *, fsdp: Optional[bool] = None,
              ep: Optional[bool] = None, sp: bool = True,
              ep2: Optional[bool] = None) -> Plan:
    """Resolve the layout for (arch, mesh).  ``None`` flags = auto."""
    msize = mesh.shape["model"]
    dsize = meshmod.dp_size(mesh)
    if fsdp is None:
        fsdp = cfg.param_count() > 2e10
    e_alloc = cfg.n_experts + cfg.n_experts_pad
    if ep is None:
        ep = cfg.n_experts > 0 and e_alloc % msize == 0
    if ep2 is None:
        ep2 = False
    if ep2 and e_alloc % (msize * dsize) != 0:
        ep2 = False
    if ep2:
        ep = True

    def div(n):
        return n % msize == 0 and n > 0

    rules: Dict[str, Optional[str]] = {
        "vocab": "model" if div(cfg.vocab) else None,
        "heads": "model" if div(cfg.n_heads) else None,
        "kv_heads": "model" if div(cfg.n_kv_heads) else None,
        "d_ff": "model" if div(cfg.d_ff) else None,
        "d_shared": "model" if div(cfg.d_shared) else None,
        "lru": "model" if div(cfg.lru_width) else None,
        "head_dim": None,
        "layers": None,
        "q_lora": None,
        "kv_lora": None,
        "d_model": "data" if (fsdp and cfg.d_model % dsize == 0) else None,
    }
    if cfg.n_experts:
        if ep:
            rules["experts"] = "model"
            rules["d_expert"] = None
        else:
            rules["experts"] = None
            rules["d_expert"] = "model" if div(cfg.d_expert) else None
    else:
        rules["experts"] = rules["d_expert"] = None

    return Plan(cfg=cfg, mesh=mesh, dp=meshmod.dp_axes(mesh), fsdp=fsdp,
                ep=ep, sp=sp, rules=rules, ep2=ep2)
