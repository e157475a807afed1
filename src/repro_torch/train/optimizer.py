"""AdamW and Adafactor on trees of tensors (a port of the JAX package's
``train/optimizer.py``).

The state is a plain tree (:class:`OptState`), updated functionally: each
step returns new parameters and a new state, and leaves the old ones as
they were.

* global-norm gradient clipping;
* decoupled weight decay, skipped for leaves of fewer than 2 dimensions;
* linear warmup, then cosine decay to ``min_lr_frac * lr``;
* Adafactor: a factored second moment for leaves whose last two axes both
  exceed 1, a bf16 first moment, RMS update clipping per leaf.

Every rule is decided per leaf of the tree, as the reference decides it.
In the training layout (``models.backbone.group_params``) a leaf is a
group's stacked tensor: a layer's norm vector is a ``(count, D)`` leaf, so
it is decayed, and factored across layers when ``count > 1``; only the
top-level ``final_norm`` ``(D,)`` escapes both.  The port mirrors that.

The schedule and the bias corrections are computed in fp32 tensors, as the
reference computes them, so that they round alike.  ``opt_axes`` gives
the state's logical axes, which ``launch.shardings`` maps onto a mesh.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Dict, NamedTuple, Tuple

import torch

from .tree import flatten, flatten_up_to, leaves, tree_map, unflatten

__all__ = ["OptConfig", "OptState", "init_opt_state", "adamw_update",
           "adafactor_update", "update", "opt_axes", "lr_schedule",
           "global_norm"]

Tree = Any


@dataclass(frozen=True)
class OptConfig:
    lr: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    # Adafactor: factored second moment for leaves of 2+ dims, bf16 first
    # moment
    factored: bool = False


class OptState(NamedTuple):
    step: torch.Tensor      # int32 scalar
    mu: Tree                # first moment
    nu: Tree                # second moment (factored: {"vr", "vc"} a leaf)


def _factored_leaf(p) -> bool:
    return p.dim() >= 2 and p.shape[-1] > 1 and p.shape[-2] > 1


def _is_v_leaf(x) -> bool:
    return isinstance(x, dict) and set(x) == {"vr", "vc"}


def init_opt_state(params: Tree, factored: bool = False) -> OptState:
    """Zero moments on each leaf's device; the step an int32 0-d tensor on
    the first leaf's."""
    device = leaves(params)[0].device
    step = torch.zeros((), dtype=torch.int32, device=device)
    zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32,  # noqa: E731
                                  device=p.device)
    if not factored:
        return OptState(step, tree_map(zeros, params),
                        tree_map(zeros, params))

    def nu_leaf(p):
        if _factored_leaf(p):
            return {"vr": torch.zeros(p.shape[:-1], dtype=torch.float32,
                                      device=p.device),
                    "vc": torch.zeros(p.shape[:-2] + p.shape[-1:],
                                      dtype=torch.float32, device=p.device)}
        return zeros(p)

    mu = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.bfloat16,
                                        device=p.device), params)
    return OptState(step, mu, tree_map(nu_leaf, params))


def is_axes(x) -> bool:
    """A leaf of a logical-axes tree: a tuple of axis names or None."""
    return isinstance(x, tuple) and all(a is None or isinstance(a, str)
                                        for a in x)


def opt_axes(param_axes: Tree, param_shapes: Tree, factored: bool = False
             ) -> OptState:
    """The logical axes of :func:`init_opt_state`'s state (``step`` has
    none); under ``factored``, a factored leaf's ``vr`` drops the last axis
    and its ``vc`` the one before."""
    if not factored:
        return OptState((), param_axes, param_axes)

    def nu_axes(ax, p):
        if _factored_leaf(p):
            return {"vr": ax[:-1], "vc": ax[:-2] + ax[-1:]}
        return ax

    return OptState((), param_axes,
                    tree_map(nu_axes, param_axes, param_shapes,
                             is_leaf=is_axes))


def _f32(x: float, like: torch.Tensor) -> torch.Tensor:
    return torch.tensor(x, dtype=torch.float32, device=like.device)


def lr_schedule(cfg: OptConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup then cosine decay to ``min_lr_frac * lr`` (fp32)."""
    s = step.float()
    warm = s / _f32(max(1.0, cfg.warmup_steps), s)
    t = (s - cfg.warmup_steps) / _f32(
        max(1.0, cfg.total_steps - cfg.warmup_steps), s)
    t = torch.clamp(t, 0.0, 1.0)
    cos = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * 0.5 * (
        1 + torch.cos(_f32(math.pi, s) * t))
    return cfg.lr * torch.where(s < cfg.warmup_steps, warm, cos)


def global_norm(tree: Tree) -> torch.Tensor:
    """sqrt of the sum over leaves (in the reference's order) of each
    leaf's sum of squares, in fp32."""
    total = 0
    for x in leaves(tree):
        total = total + torch.sum(torch.square(x.float()))
    return torch.sqrt(total)


def _clip_scale(cfg: OptConfig, gnorm: torch.Tensor) -> torch.Tensor:
    return torch.clamp(cfg.clip_norm / (gnorm + 1e-9), max=1.0)


@torch.no_grad()
def adamw_update(cfg: OptConfig, params: Tree, grads: Tree, state: OptState
                 ) -> Tuple[Tree, OptState, Dict[str, torch.Tensor]]:
    """One AdamW step.  Returns (new_params, new_state, metrics)."""
    gnorm = global_norm(grads)
    scale = _clip_scale(cfg, gnorm)

    step = state.step + 1
    t = step.float()
    b1c = 1 - torch.pow(_f32(cfg.b1, t), t)
    b2c = 1 - torch.pow(_f32(cfg.b2, t), t)
    lr = lr_schedule(cfg, state.step)

    # Each leaf in the reference's operations and order, worked in place
    # on two scratch tensors, so a large leaf costs few allocations:
    #   g = g * scale;  m' = b1 m + (1 - b1) g;  n' = b2 n + (1 - b2) g g
    #   delta = (m' / b1c) / (sqrt(n' / b2c) + eps)  [+ wd p if 2+ dims]
    #   p' = p - lr delta
    def upd(p, g, m, n):
        a = g.float() * scale
        c = torch.mul(a, 1 - cfg.b1)
        m_new = torch.mul(m, cfg.b1).add_(c)
        torch.mul(a, 1 - cfg.b2, out=c).mul_(a)
        n_new = torch.mul(n, cfg.b2).add_(c)
        torch.div(m_new, b1c, out=a)
        torch.div(n_new, b2c, out=c).sqrt_().add_(cfg.eps)
        a.div_(c)
        pf = p.float()
        if p.dim() >= 2:                        # decoupled decay, not 1-D
            a.add_(torch.mul(pf, cfg.weight_decay, out=c))
        return torch.sub(pf, a.mul_(lr)).to(p.dtype), m_new, n_new

    flat_p, s = flatten(params)
    out = [upd(*xs) for xs in zip(flat_p, flatten_up_to(s, grads),
                                  flatten_up_to(s, state.mu),
                                  flatten_up_to(s, state.nu))]
    new = [unflatten(s, [o[i] for o in out]) for i in range(3)]
    return new[0], OptState(step, new[1], new[2]), {"grad_norm": gnorm,
                                                    "lr": lr}


@torch.no_grad()
def adafactor_update(cfg: OptConfig, params: Tree, grads: Tree,
                     state: OptState
                     ) -> Tuple[Tree, OptState, Dict[str, torch.Tensor]]:
    """Adafactor (Shazeer & Stern 2018) with a bf16 first moment: factored
    second moment for leaves of 2+ dims, per-leaf RMS update clipping,
    decoupled weight decay."""
    gnorm = global_norm(grads)
    scale = _clip_scale(cfg, gnorm)
    step = state.step + 1
    t = step.float()
    beta2 = 1.0 - torch.pow(t, _f32(-0.8, t))     # Adafactor's schedule
    lr = lr_schedule(cfg, state.step)

    # Each leaf in the reference's operations and order, worked in place
    # on two scratch tensors (a: g, then u; c: g^2, then vhat, ...):
    #   g = g * scale;  g2 = g g + 1e-30;  vhat from g2 (factored: the
    #   row and column means);  u = g rsqrt(vhat + eps), RMS-clipped at 1;
    #   m' = b1 m + (1 - b1) u;  p' = p - lr (m' [+ wd p if 2+ dims])
    def upd(p, g, m, v):
        a = g.float() * scale
        c = torch.mul(a, a).add_(1e-30)
        if _is_v_leaf(v):                          # factored
            vr = beta2 * v["vr"] + (1 - beta2) * c.mean(dim=-1)
            vc = beta2 * v["vc"] + (1 - beta2) * c.mean(dim=-2)
            denom = torch.clamp(vr.mean(dim=-1, keepdim=True), min=1e-30)
            torch.mul((vr / denom)[..., None], vc[..., None, :], out=c)
            c.add_(cfg.eps)
            v_new = {"vr": vr, "vc": vc}
        else:
            v_new = torch.mul(v, beta2).add_(c.mul_(1 - beta2))
            torch.add(v_new, cfg.eps, out=c)
        a.mul_(c.rsqrt_())
        rms = torch.sqrt(torch.mean(torch.square(a, out=c)) + 1e-30)
        a.div_(torch.clamp(rms, min=1.0))          # RMS clipping at 1.0
        delta = m.float().mul(cfg.b1).add_(torch.mul(a, 1 - cfg.b1, out=c))
        m_new = delta.to(torch.bfloat16)
        pf = p.float()
        if p.dim() >= 2:
            delta.add_(torch.mul(pf, cfg.weight_decay, out=c))
        return torch.sub(pf, delta.mul_(lr)).to(p.dtype), m_new, v_new

    flat_p, s = flatten(params)
    out = [upd(*xs) for xs in zip(flat_p, flatten_up_to(s, grads),
                                  flatten_up_to(s, state.mu),
                                  flatten_up_to(s, state.nu))]
    new = [unflatten(s, [o[i] for o in out]) for i in range(3)]
    return new[0], OptState(step, new[1], new[2]), {"grad_norm": gnorm,
                                                    "lr": lr}


def update(cfg: OptConfig, params: Tree, grads: Tree, state: OptState):
    """Dispatch on ``cfg.factored``."""
    if cfg.factored:
        return adafactor_update(cfg, params, grads, state)
    return adamw_update(cfg, params, grads, state)
