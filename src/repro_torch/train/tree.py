"""Trees of tensors, flattened in JAX's order.

The training state is a nest of dicts, lists, tuples and NamedTuples
(``TrainState``, ``OptState``, ``Compressed``) over tensors.  The JAX
package walks it with ``jax.tree``; the port walks it here, in the same
order: dict keys sorted, NamedTuple fields and list / tuple items by
index, ``None`` an empty subtree.  So a sum over the leaves (the global
gradient norm) adds in the reference's order, and a checkpoint's
``leaf_<i>`` is the reference's leaf i.
"""
from __future__ import annotations

from typing import Any, Callable, List, Optional, Tuple

__all__ = ["leaves", "flatten", "unflatten", "flatten_up_to", "tree_map"]

Tree = Any


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _children(node):
    """(kind, keys, children) of an inner node, or None for a leaf."""
    if isinstance(node, dict):
        keys = sorted(node)
        return "dict", keys, [node[k] for k in keys]
    if _is_namedtuple(node):
        return type(node), None, list(node)
    if isinstance(node, (list, tuple)):
        return type(node), len(node), list(node)
    if node is None:
        return "none", None, []
    return None


def flatten(tree: Tree, is_leaf: Optional[Callable[[Any], bool]] = None
            ) -> Tuple[List[Any], Any]:
    """(leaves in JAX's order, a structure :func:`unflatten` rebuilds);
    a node for which ``is_leaf`` holds is a leaf (a tuple of axis names,
    say), as ``jax.tree.flatten``'s ``is_leaf``."""
    out: List[Any] = []

    def walk(node):
        if is_leaf is not None and is_leaf(node):
            out.append(node)
            return "*"
        c = _children(node)
        if c is None:
            out.append(node)
            return "*"
        kind, keys, kids = c
        return kind, keys, [walk(k) for k in kids]

    return out, walk(tree)


def unflatten(structure, leaves_: List[Any]):
    it = iter(leaves_)

    def build(s):
        if s == "*":
            return next(it)
        kind, keys, kids = s
        vals = [build(k) for k in kids]
        if kind == "dict":
            return dict(zip(keys, vals))
        if kind == "none":
            return None
        if kind in (list, tuple):
            return kind(vals)
        return kind(*vals)                  # a NamedTuple

    out = build(structure)
    if next(it, it) is not it:
        raise ValueError("more leaves than the structure holds")
    return out


def leaves(tree: Tree) -> List[Any]:
    return flatten(tree)[0]


def tree_map(fn: Callable, tree: Tree, *rest: Tree,
             is_leaf: Optional[Callable[[Any], bool]] = None) -> Tree:
    """``fn`` over the leaves of ``tree`` and the matching subtrees of
    ``rest`` (which must have at least ``tree``'s structure, as
    ``jax.tree.map``)."""
    flat, s = flatten(tree, is_leaf)
    others = [flatten_up_to(s, r) for r in rest]
    return unflatten(s, [fn(*xs) for xs in zip(flat, *others)])


def flatten_up_to(s, tree) -> List[Any]:
    """The subtrees of ``tree`` at the leaves of structure ``s``."""
    out: List[Any] = []

    def walk(s_, node):
        if s_ == "*":
            out.append(node)
            return
        kind, keys, kids = s_
        if kind == "dict":
            if sorted(node) != keys:
                raise ValueError(f"dict keys {sorted(node)} != {keys}")
            sub = [node[k] for k in keys]
        elif kind == "none":
            if node is not None:
                raise ValueError("expected None")
            sub = []
        else:
            sub = list(node)
            if len(sub) != len(kids):
                raise ValueError(f"{len(sub)} children != {len(kids)}")
        for k, n in zip(kids, sub):
            walk(k, n)

    walk(s, tree)
    return out
