"""Plain AdamW (Loshchilov and Hutter, arXiv:1711.05101) with global-norm
clipping and a warmup-cosine schedule, as a traffic mix's ``optimizer``
entry states them:

* the gradient is scaled by ``min(1, clip_norm / ||g||)``, ``||g||`` the
  norm over every leaf;
* the learning rate of update ``t`` (0 for the first) is ``lr t /
  warmup_steps`` while ``t < warmup_steps``, then a cosine from ``lr`` to
  ``min_lr_frac lr`` at ``total_steps``;
* moments with bias correction; the decay ``weight_decay p`` is added to
  the update of every leaf of at least ``decay_min_dims`` dimensions.

The state is worked in place on the reference's own tensors.
"""
from __future__ import annotations

import math
from typing import Dict, List

import torch


def lr_at(spec: Dict, t: int) -> float:
    if t < spec["warmup_steps"]:
        return spec["lr"] * t / spec["warmup_steps"]
    frac = min(1.0, (t - spec["warmup_steps"])
               / max(1, spec["total_steps"] - spec["warmup_steps"]))
    lo = spec["min_lr_frac"]
    return spec["lr"] * (lo + (1 - lo) * 0.5 * (1 + math.cos(math.pi * frac)))


class AdamW:
    def __init__(self, spec: Dict, params: List[torch.Tensor]):
        if spec["name"] != "adamw":
            raise ValueError(f"the reference has no optimizer "
                             f"{spec['name']!r}")
        self.spec, self.t = spec, 0
        self.m = [torch.zeros_like(p) for p in params]
        self.v = [torch.zeros_like(p) for p in params]

    @torch.no_grad()
    def step(self, params: List[torch.Tensor], grads: List[torch.Tensor]
             ) -> List[torch.Tensor]:
        """Update ``params`` in place; returns the clipped gradients."""
        s = self.spec
        gnorm = math.sqrt(sum(float(g.double().pow(2).sum()) for g in grads))
        scale = min(1.0, s["clip_norm"] / gnorm)
        lr = lr_at(s, self.t)
        self.t += 1
        c1, c2 = 1 - s["b1"] ** self.t, 1 - s["b2"] ** self.t
        clipped = []
        for p, g, m, v in zip(params, grads, self.m, self.v):
            g = g * scale
            clipped.append(g)
            m.mul_(s["b1"]).add_(g, alpha=1 - s["b1"])
            v.mul_(s["b2"]).addcmul_(g, g, value=1 - s["b2"])
            u = (m / c1) / ((v / c2).sqrt() + s["eps"])
            if p.dim() >= s["decay_min_dims"]:
                u.add_(p, alpha=s["weight_decay"])
            p.sub_(u, alpha=lr)
        return clipped
