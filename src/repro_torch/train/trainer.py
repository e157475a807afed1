"""The train step and eval step factories (a port of the JAX package's
``train/trainer.py``).

``make_train_step`` builds ``(state, batch) -> (state, metrics)``:

* gradient accumulation over ``microbatches``: the batch split along B,
  the gradients summed in fp32 from zeros in microbatch order and divided
  by the count, the loss averaged, the other metrics those of the last
  microbatch, as the reference's ``lax.scan``;
* optional int8 compression of the gradient, with the error feedback
  carried in the state, before the optimizer;
* the parameters in the training layout (``backbone.group_params``); their
  dtype is the caller's choice, the optimizer state is fp32 (bf16 first
  moment under Adafactor).

Metrics: ``loss``, ``xent``, ``aux``, ``grad_norm`` and ``lr``, 0-d
tensors on the parameters' device.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, NamedTuple, Optional, Tuple

import torch

from ..device import resolve_device
from ..models import backbone
from ..models.config import ModelConfig
from . import optimizer
from .compression import compress_int8, decompress_int8
from .optimizer import OptConfig, OptState, init_opt_state
from .tree import flatten, tree_map, unflatten

__all__ = ["TrainState", "make_train_step", "make_eval_step",
           "init_train_state"]

Tree = Any


class TrainState(NamedTuple):
    params: Tree
    opt: OptState
    err: Optional[Tree]        # int8-compression error feedback (or None)


def init_train_state(cfg: ModelConfig, generator: torch.Generator,
                     dtype=torch.float32, compress: bool = False,
                     factored: bool = False, device="cuda") -> TrainState:
    """Parameters drawn from ``generator`` (``backbone.init_params``) in
    the training layout on ``device``, zero optimizer state, and a zero
    error feedback when ``compress``."""
    device = resolve_device(device)
    params = backbone.group_params(
        cfg, backbone.init_params(cfg, generator, dtype=dtype, device=device))
    err = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                         device=p.device),
                   params) if compress else None
    return TrainState(params, init_opt_state(params, factored), err)


def _grad_fn(cfg: ModelConfig, remat: bool):
    def value_and_grad(params, batch):
        flat, s = flatten(params)
        xs = [p.detach().requires_grad_(True) for p in flat]
        with torch.enable_grad():
            loss, metrics = backbone.lm_loss(cfg, unflatten(s, xs), batch,
                                             remat=remat)
            grads = torch.autograd.grad(loss, xs)
        metrics = {k: v.detach() for k, v in metrics.items()}
        return loss.detach(), metrics, unflatten(s, list(grads))
    return value_and_grad


def make_train_step(cfg: ModelConfig, opt_cfg: OptConfig,
                    microbatches: int = 1, remat: bool = True,
                    compress_grads: bool = False
                    ) -> Callable[[TrainState, Dict[str, torch.Tensor]],
                                  Tuple[TrainState, Dict[str, torch.Tensor]]]:
    """Build ``(state, batch) -> (state, metrics)``.  ``batch["tokens"]``
    is (B, T); with ``microbatches=k`` it is split into k slices along B
    (k must divide B)."""
    grad_fn = _grad_fn(cfg, remat)

    def train_step(state: TrainState, batch) -> Tuple[TrainState, Dict]:
        if microbatches == 1:
            loss, metrics, grads = grad_fn(state.params, batch)
        else:
            b = batch["tokens"].shape[0]
            if b % microbatches:
                raise ValueError(f"batch {b} is not a multiple of "
                                 f"{microbatches} microbatches")
            n = b // microbatches
            gsum = tree_map(lambda p: torch.zeros(
                p.shape, dtype=torch.float32, device=p.device), state.params)
            lsum = 0.0
            for i in range(microbatches):
                mb = {k: v[i * n:(i + 1) * n] for k, v in batch.items()}
                l, metrics, g = grad_fn(state.params, mb)
                gsum = tree_map(torch.add, gsum, g)
                lsum = lsum + l
            grads = tree_map(lambda g: g / microbatches, gsum)
            loss = lsum / microbatches

        err = state.err
        if compress_grads:
            # int8 + error feedback: quantize (grad + carried error); the
            # residual goes back into the carry
            comp, err = compress_int8(tree_map(torch.add, grads, err))
            grads = decompress_int8(comp)

        new_params, new_opt, opt_metrics = optimizer.update(
            opt_cfg, state.params, grads, state.opt)
        metrics = dict(metrics)
        metrics.update(opt_metrics)
        metrics["loss"] = loss
        return TrainState(new_params, new_opt, err), metrics

    return train_step


def make_eval_step(cfg: ModelConfig, remat: bool = False):
    @torch.no_grad()
    def eval_step(params, batch):
        loss, metrics = backbone.lm_loss(cfg, params, batch, remat=remat)
        return {"loss": loss, **metrics}
    return eval_step
