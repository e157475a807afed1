"""Carry the JAX package's parameters across to the port.

The reference's ``backbone.init_params`` returns a tree with ``embed``,
``head``, ``final_norm`` and ``groups``: one dict per ``layer_groups``
entry, every leaf stacked with a leading ``count`` axis (an MoE layer's
expert leaves are then (count, E, D, F)); for an MTP config, ``mtp``:
one unstacked attention block with its projection and norms, which both
layouts carry as it is; for an encoder-decoder, ``enc``: ``groups`` (one
group of ``encoder_layers``) and ``final_norm``.  The port serves from one
dict per layer in plan order (``repro_torch.models.backbone``):
:func:`params_from_reference` unstacks the groups (the encoder's into
``enc["layers"]``) into that layout.  It
trains on the reference's own layout: :func:`grouped_params_from_reference`
carries the tree across as it is.  Both take numpy arrays (call
``np.asarray`` on the reference's leaves first) and import nothing of JAX.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from ..device import resolve_device
from .config import ModelConfig, layer_groups

__all__ = ["params_from_reference", "grouped_params_from_reference"]


def _tensor(a, device) -> torch.Tensor:
    """A copy of ``a`` (the reference's arrays are read-only) in its own
    dtype; bf16 (an ml_dtypes array) goes through an exact fp32 widening."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.astype(np.float32)).to(
            device=device, dtype=torch.bfloat16)
    return torch.from_numpy(np.array(a)).to(device=device)


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_map(fn, v) for v in tree]
    return fn(tree)


def params_from_reference(cfg: ModelConfig, tree: Dict[str, Any],
                          device="cuda"):
    """The port's parameters from the reference's ``init_params`` tree (as
    numpy arrays), in the reference's dtypes, on ``device``."""
    device = resolve_device(device)
    groups = layer_groups(cfg)
    if len(tree["groups"]) != len(groups):
        raise ValueError(f"the tree has {len(tree['groups'])} groups, the "
                         f"config {len(groups)}")
    layers = []
    for (spec, count), group in zip(groups, tree["groups"]):
        layers.extend(_unstack(spec.kind, count, group, device))
    out = {"embed": _tensor(tree["embed"], device),
           "layers": layers,
           "final_norm": _tensor(tree["final_norm"], device)}
    for k in ("head", "mtp"):
        if k in tree:
            out[k] = _map(lambda a: _tensor(a, device), tree[k])
    if "enc" in tree:
        (group,) = tree["enc"]["groups"]
        out["enc"] = {"layers": _unstack("encoder", cfg.encoder_layers,
                                         group, device),
                      "final_norm": _tensor(tree["enc"]["final_norm"],
                                            device)}
    return out


def _unstack(what: str, count: int, group, device):
    """The ``count`` per-layer dicts of a stacked group."""
    def leaf(i):
        def pick(a):
            a = np.asarray(a)
            if a.shape[0] != count:
                raise ValueError(f"a {what} group leaf has leading axis "
                                 f"{a.shape[0]}, expected {count}")
            return _tensor(a[i], device)
        return pick
    return [_map(leaf(i), group) for i in range(count)]


def grouped_params_from_reference(cfg: ModelConfig, tree: Dict[str, Any],
                                  device="cuda"):
    """The reference's ``init_params`` tree (as numpy arrays) in the
    port's training layout (``backbone.group_params``): the same tree, the
    groups stacked as they are, in the reference's dtypes, on ``device``."""
    device = resolve_device(device)
    groups = layer_groups(cfg)
    if len(tree["groups"]) != len(groups):
        raise ValueError(f"the tree has {len(tree['groups'])} groups, the "
                         f"config {len(groups)}")
    keys = ("embed", "groups", "final_norm", "head", "mtp", "enc")
    return {k: _map(lambda a: _tensor(a, device), tree[k])
            for k in keys if k in tree}
