"""The reference's readings of a training cell's first steps.

From the seed alone: the parameters (``bench.weights`` over the
reference's own layout) and every batch (``bench.gen``), the same the
program was given.  It runs the traffic's ``checked_steps`` steps of the
configuration's loss and AdamW and returns, by dotted leaf path, what
the comparison reads:

* ``loss``: each step's loss;
* ``grad``: each leaf's norm of the first step's clipped gradient;
* ``change``: each leaf's norm of its change over those steps.

``tf32`` computes every matrix product in TF32 (the control of the
comparison): on the card by letting cuBLAS use TF32, on the CPU by
rounding each product's operands to TF32's 10-bit mantissa.
"""
from __future__ import annotations

import contextlib
import importlib
from typing import Dict

import torch

from .. import gen, weights
from .adamw import AdamW


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """x rounded to the nearest TF32 value (ties to even), kept fp32."""
    b = x.contiguous().view(torch.int32)
    b = b + (0x0FFF + ((b >> 13) & 1))
    return (b & ~0x1FFF).view(torch.float32)


@contextlib.contextmanager
def precision(tf32: bool, device):
    """fp32 products, or TF32 ones for the control."""
    cuda = torch.backends.cuda.matmul
    old = cuda.allow_tf32, torch.backends.cudnn.allow_tf32
    cuda.allow_tf32 = torch.backends.cudnn.allow_tf32 = (
        tf32 and torch.device(device).type == "cuda")
    patched = []
    if tf32 and torch.device(device).type == "cpu":
        for mod, name in ((torch, "einsum"), (torch, "matmul"),
                          (torch.Tensor, "__matmul__")):
            orig = getattr(mod, name)
            patched.append((mod, name, orig))
            setattr(mod, name, _rounding(orig))
    try:
        yield
    finally:
        for mod, name, orig in patched:
            setattr(mod, name, orig)
        cuda.allow_tf32, torch.backends.cudnn.allow_tf32 = old


def _rounding(fn):
    """``fn`` with its fp32 tensor operands rounded to TF32 in the forward
    (the gradient passes the rounding unchanged)."""
    def rounded(a):
        if not isinstance(a, torch.Tensor) or a.dtype != torch.float32:
            return a
        d = a.detach()
        return a + (round_tf32(d) - d)

    def wrapped(*args):
        return fn(*(rounded(a) for a in args))
    return wrapped


def readings(config: Dict, traffic: Dict, seed: int, device,
             tf32: bool = False) -> Dict:
    m = config["model"]
    model = importlib.import_module(f".{config['reference']}", __package__)
    lay = model.layout(m)
    params = weights.make_params(lay, seed, device)
    names, leaves = zip(*weights.leaf_items(params))
    for p in leaves:
        p.requires_grad_(True)
    opt = AdamW(traffic["optimizer"], list(leaves))
    data = gen.TrainTraffic(traffic, m, device)
    out = {"loss": [], "grad": {}, "change": {}}
    with precision(tf32, device):
        for i in range(traffic["checked_steps"]):
            loss = model.loss(m, params, data.batch(seed, i))
            grads = torch.autograd.grad(loss, leaves)
            out["loss"].append(float(loss.detach()))
            clipped = opt.step(list(leaves), list(grads))
            if i == 0:
                out["grad"] = {k: float(g.norm()) for k, g in
                               zip(names, clipped)}
            del loss, grads, clipped
    del opt
    start = dict(weights.leaf_items(weights.make_params(lay, seed, device)))
    with torch.no_grad():
        out["change"] = {k: float((p - start[k]).norm())
                         for k, p in zip(names, leaves)}
    return out
