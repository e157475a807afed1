"""int8 gradient compression with error feedback (a port of the JAX
package's ``train/compression.py``).

Per-tensor symmetric quantization: ``scale = max(amax / 127, 1e-12)``,
``q = clip(round(g / scale), -127, 127)`` (round half to even, as
``jnp.round``), the scale carried beside.  The residual goes back into the
caller's carry, so that

    decompress(compress(g + e)) + e' == g + e   (up to rounding)

On a data-parallel mesh the int8 tensor is what would cross the data axis;
one card has no all-reduce to shrink, so the codec and its invariant are
what this module delivers.
"""
from __future__ import annotations

from typing import Any, NamedTuple, Tuple

import torch

from .tree import flatten, unflatten

__all__ = ["Compressed", "compress_int8", "decompress_int8"]

Tree = Any


class Compressed(NamedTuple):
    q: Tree          # int8 tensors
    scale: Tree      # fp32 0-d tensors


def _q_one(g: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    g = g.float()
    amax = torch.max(torch.abs(g))
    scale = torch.clamp(amax / 127.0, min=1e-12)
    q = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
    return q, scale


@torch.no_grad()
def compress_int8(grads: Tree) -> Tuple[Compressed, Tree]:
    """Quantize; return (compressed, new_error_feedback)."""
    flat, s = flatten(grads)
    qs = [_q_one(g) for g in flat]
    comp = Compressed(unflatten(s, [q for q, _ in qs]),
                      unflatten(s, [sc for _, sc in qs]))
    deq = flatten(decompress_int8(comp))[0]
    err = unflatten(s, [g.float() - d for g, d in zip(flat, deq)])
    return comp, err


@torch.no_grad()
def decompress_int8(comp: Compressed) -> Tree:
    flat_q, s = flatten(comp.q)
    flat_s = flatten(comp.scale)[0]
    return unflatten(s, [q.float() * sc for q, sc in zip(flat_q, flat_s)])
