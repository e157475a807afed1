"""Initial parameters from the seed, on the device, in a few large calls.

A layout is a list of ``(path, shape, scale)``: ``path`` a tuple of dict
keys and list indices, ``scale`` the bound of a uniform draw, 0 for a
zero leaf.  One uniform draw fills a flat fp32 buffer for every drawn
leaf; each such leaf is a view of it, scaled in place.  The same seed on
the same device gives the same parameters, to the program and to the
reference alike.
"""
from __future__ import annotations

import math
from typing import Any, List, Sequence, Tuple

import torch

from .gen import WEIGHTS_STREAM, seed_word

Leaf = Tuple[Tuple[Any, ...], Tuple[int, ...], float]


def nest(items: Sequence[Tuple[Tuple[Any, ...], Any]]):
    """A tree of dicts (str keys) and lists (int keys) from
    ``(path, value)`` pairs; list indices come in order."""
    root: dict = {}
    for path, value in items:
        node = root
        for key, nxt in zip(path[:-1], path[1:]):
            if isinstance(node, list):
                while len(node) <= key:
                    node.append([] if isinstance(nxt, int) else {})
                node = node[key]
            else:
                node = node.setdefault(key, [] if isinstance(nxt, int)
                                       else {})
        node[path[-1]] = value
    return root


def make_params(layout: List[Leaf], seed: int, device):
    """The tree of ``layout``'s fp32 leaves drawn from ``seed`` on
    ``device``."""
    device = torch.device(device)
    drawn = sum(math.prod(s) for _, s, sc in layout if sc)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed_word(seed, WEIGHTS_STREAM))
    flat = torch.empty(drawn, dtype=torch.float32, device=device)
    flat.uniform_(-1.0, 1.0, generator=gen)
    items, off = [], 0
    for path, shape, scale in layout:
        n = math.prod(shape)
        if scale:
            leaf = flat[off:off + n].view(shape).mul_(scale)
            off += n
        else:
            leaf = torch.zeros(shape, dtype=torch.float32, device=device)
        items.append((path, leaf))
    return nest(items)


def leaf_items(tree, prefix: Tuple[Any, ...] = ()):
    """``(dotted path, tensor)`` of every leaf, dict keys sorted."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from leaf_items(tree[k], prefix + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from leaf_items(v, prefix + (i,))
    else:
        yield ".".join(str(p) for p in prefix), tree
