"""Model backbone of the serving path: parameter init, the layer loop,
prefill and decode (a port of the JAX package's ``models/backbone.py``).

The reference stacks consecutive identical layers and runs each group with
``lax.scan``; PyTorch runs eagerly, so the port keeps one parameter dict
per layer, in plan order (``config.layer_plan``), and loops over them.
``repro_torch.models.convert`` unstacks the reference's groups into this
layout.  Caches are a list of per-layer dicts in the same order.

Serving only: ``lm_loss``, the encoder, the vision frontend and MTP come
with later slices (``ROADMAP.md``).
"""
from __future__ import annotations

from typing import Any, Dict, List

import torch

from ..device import resolve_device
from . import blocks
from .config import (ATTN, LOCAL_ATTN, MOE, RGLRU, RWKV6, BlockSpec,
                     ModelConfig, layer_plan)
from .layers import norm, uinit

__all__ = ["init_params", "init_cache", "slot_view", "forward",
           "embed_tokens", "logits_fn", "prefill", "decode_step"]

Params = Dict[str, Any]


def _check_served(cfg: ModelConfig) -> None:
    if cfg.is_encdec:
        raise blocks.not_ported("cross")
    if cfg.frontend or cfg.mtp:
        raise NotImplementedError(
            "frontends and MTP come with a later slice of the PyTorch port; "
            "see ROADMAP.md")


# =========================================================================== #
# init                                                                         #
# =========================================================================== #
def _layer_init(cfg: ModelConfig, spec: BlockSpec, gen, dtype, device):
    if spec.kind in (ATTN, LOCAL_ATTN):
        mix = blocks.attn_init(cfg, gen, dtype, device)
    elif spec.kind == RWKV6:      # owns its channel mix: no MLP entry
        return {"mix": blocks.rwkv6_init(cfg, gen, dtype, device)}
    elif spec.kind == RGLRU:
        mix = blocks.rglru_init(cfg, gen, dtype, device)
    else:
        raise blocks.not_ported(spec.kind)
    if spec.mlp == MOE:
        raise blocks.not_ported(MOE)
    return {"mix": mix, "mlp": blocks.mlp_block_init(cfg, gen, dtype, device)}


def init_params(cfg: ModelConfig, generator: torch.Generator,
                dtype=torch.float32, device="cuda") -> Params:
    """Scaled-uniform parameters (as the reference's ``uinit``), drawn in
    fp32 from ``generator`` on its own device, then cast to ``dtype`` on
    ``device``.  They cannot reproduce ``jax.random``'s bits: to compare
    with the reference, carry its parameters across with
    :func:`repro_torch.models.convert.params_from_reference`."""
    device = resolve_device(device)
    _check_served(cfg)
    D, V = cfg.d_model, cfg.vocab
    params: Params = {"embed": uinit(generator, (V, D), 0.02, dtype, device)}
    params["layers"] = [_layer_init(cfg, spec, generator, dtype, device)
                        for spec in layer_plan(cfg)]
    params["final_norm"] = torch.zeros((D,), dtype=dtype, device=device)
    if not cfg.tie_embeddings:
        params["head"] = uinit(generator, (D, V), 0.02, dtype, device)
    return params


# =========================================================================== #
# caches                                                                       #
# =========================================================================== #
def _block_cache(cfg: ModelConfig, spec: BlockSpec, B: int, S: int, dtype,
                 device) -> Dict[str, torch.Tensor]:
    """One layer's ``mix`` cache.  The int8 layout exists for attention KV
    only (:func:`blocks.attn_cache`: int8 values, fp32 scales): recurrent
    caches stay bf16 under an int8 request, as the reference's
    ``_block_cache`` keeps them."""
    alt = torch.bfloat16 if dtype == torch.int8 else dtype
    if spec.kind == ATTN:
        return blocks.attn_cache(cfg, B, S, dtype, device)
    if spec.kind == LOCAL_ATTN:
        return blocks.attn_cache(cfg, B, min(S, cfg.window), dtype, device)
    if spec.kind == RWKV6:
        return blocks.rwkv6_cache(cfg, B, S, alt, device)
    if spec.kind == RGLRU:
        return blocks.rglru_cache(cfg, B, S, alt, device)
    raise blocks.not_ported(spec.kind)


def init_cache(cfg: ModelConfig, B: int, S: int, dtype=torch.bfloat16,
               device="cuda") -> List[Dict[str, Dict[str, torch.Tensor]]]:
    """Decode caches, one ``{"mix": ...}`` dict per layer in plan order.
    bf16 by default, as the reference; the RG-LRU state ``h`` and the RWKV6
    state ``s`` stay fp32.  An int8 request gives attention layers the
    quantized KV layout and keeps the other recurrent caches bf16
    (:func:`_block_cache`).
    A local-attention layer's cache is its window, ``min(S, window)``."""
    device = resolve_device(device)
    _check_served(cfg)
    return [{"mix": _block_cache(cfg, spec, B, S, dtype, device)}
            for spec in layer_plan(cfg)]


def slot_view(caches, slot: int):
    """The caches of batch row ``slot`` as views (batch size 1): writing
    them writes the full caches."""
    return [{"mix": {k: v[slot:slot + 1] for k, v in c["mix"].items()}}
            for c in caches]


# =========================================================================== #
# forward                                                                      #
# =========================================================================== #
def _apply_block(cfg: ModelConfig, spec: BlockSpec, p, h, mode, cache, pos):
    if spec.kind == ATTN:
        h, _ = blocks.attn_apply(cfg, p["mix"], h, mode, cache, pos,
                                 causal=cfg.causal)
    elif spec.kind == LOCAL_ATTN:
        h, _ = blocks.attn_apply(cfg, p["mix"], h, mode, cache, pos,
                                 window=cfg.window)
    elif spec.kind == RWKV6:      # owns its channel mix
        h, _ = blocks.rwkv6_apply(cfg, p["mix"], h, mode, cache, pos)
        return h
    elif spec.kind == RGLRU:
        h, _ = blocks.rglru_apply(cfg, p["mix"], h, mode, cache, pos)
    else:
        raise blocks.not_ported(spec.kind)
    if spec.mlp == MOE:
        raise blocks.not_ported(MOE)
    return blocks.mlp_block_apply(cfg, p["mlp"], h)


def forward(cfg: ModelConfig, params: Params, h, mode: str, caches=None,
            pos=0):
    """Backbone over input embeddings h (B, T, D).  Returns (h, caches):
    the caches, when given, are written in place.  (The reference also
    returns the MoE auxiliary loss, which a dense stack does not have.)"""
    for i, spec in enumerate(layer_plan(cfg)):
        cache = caches[i]["mix"] if caches is not None else None
        h = _apply_block(cfg, spec, params["layers"][i], h, mode, cache, pos)
    h = norm(h, params["final_norm"], cfg.norm_kind, cfg.norm_eps)
    return h, caches


def embed_tokens(cfg: ModelConfig, params: Params, tokens):
    return params["embed"][tokens]


def logits_fn(cfg: ModelConfig, params: Params, h):
    w = params["embed"].T if cfg.tie_embeddings else params["head"]
    return h @ w


# =========================================================================== #
# serving                                                                      #
# =========================================================================== #
def prefill(cfg: ModelConfig, params: Params, batch, caches):
    """Process the full prompt (``batch["tokens"]``, (B, T)), fill caches,
    return last-token logits."""
    h = embed_tokens(cfg, params, batch["tokens"])
    h, caches = forward(cfg, params, h, "prefill", caches=caches)
    return logits_fn(cfg, params, h[:, -1]), caches


def decode_step(cfg: ModelConfig, params: Params, tokens, caches, pos):
    """One decode step.  tokens: (B,) int; pos: an int or a (B,) integer
    tensor of per-request positions."""
    h = embed_tokens(cfg, params, tokens[:, None])
    h, caches = forward(cfg, params, h, "decode", caches=caches, pos=pos)
    return logits_fn(cfg, params, h[:, 0]), caches
