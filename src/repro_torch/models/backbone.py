"""Model backbone: parameter init, the layer loop, the training loss,
prefill and decode (a port of the JAX package's ``models/backbone.py``).

The reference stacks consecutive identical layers and runs each group with
``lax.scan``; PyTorch runs eagerly and loops over the layers.  Parameters
come in two layouts, and every function here takes either:

* serving: ``params["layers"]``, one dict per layer in plan order
  (``config.layer_plan``), as ``init_params`` makes them;
* training: ``params["groups"]``, the reference's tree — one dict per
  ``layer_groups`` entry, every leaf stacked with a leading ``count`` axis
  (:func:`group_params`).  The optimizer decides weight decay and
  factoring per stacked leaf, as the reference's does, so the training
  state keeps this layout; the loop takes per-layer views of it, and
  autograd gives the gradients on the stacked leaves.

``repro_torch.models.convert`` carries the reference's tree into either
layout.  Caches are a list of per-layer dicts in plan order.  DeepSeek's
multi-token-prediction depth (``params["mtp"]``, one unstacked attention
block) sits beside the layers in both layouts, as in the reference.

``forward`` returns the MoE auxiliary loss beside the hidden states, as
the reference's does; ``lm_loss`` adds it (and the MTP loss) to the
cross-entropy.  The encoder and the vision frontend come with a later
slice (``ROADMAP.md``).
"""
from __future__ import annotations

from typing import Any, Dict, List

import torch
from torch.utils.checkpoint import checkpoint

from ..device import resolve_device
from . import blocks, moe
from .config import (ATTN, DENSE, LOCAL_ATTN, MLA, MOE, RGLRU, RWKV6,
                     BlockSpec, ModelConfig, layer_groups, layer_plan)
from .layers import norm, uinit

__all__ = ["init_params", "group_params", "layer_params", "init_cache",
           "slot_view", "forward", "embed_tokens", "logits_fn", "lm_loss",
           "prefill", "decode_step"]

Params = Dict[str, Any]

#: the MTP depth's block, whatever the stack's kinds (an attention layer
#: with a dense MLP, as the reference's)
_MTP_SPEC = BlockSpec(ATTN, DENSE)


def _check_served(cfg: ModelConfig) -> None:
    if cfg.is_encdec:
        raise blocks.not_ported("cross")
    if cfg.frontend:
        raise NotImplementedError(
            "frontends come with a later slice of the PyTorch port; see "
            "ROADMAP.md")


# =========================================================================== #
# init                                                                         #
# =========================================================================== #
def _layer_init(cfg: ModelConfig, spec: BlockSpec, gen, dtype, device):
    if spec.kind in (ATTN, LOCAL_ATTN):
        mix = blocks.attn_init(cfg, gen, dtype, device)
    elif spec.kind == MLA:
        mix = blocks.mla_init(cfg, gen, dtype, device)
    elif spec.kind == RWKV6:      # owns its channel mix: no MLP entry
        return {"mix": blocks.rwkv6_init(cfg, gen, dtype, device)}
    elif spec.kind == RGLRU:
        mix = blocks.rglru_init(cfg, gen, dtype, device)
    else:
        raise blocks.not_ported(spec.kind)
    if spec.mlp == MOE:
        return {"mix": mix, "mlp": moe.moe_init(cfg, gen, dtype, device)}
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
    if cfg.mtp:                   # one extra depth: an attention block
        params["mtp"] = {
            "proj": uinit(generator, (2 * D, D), None, dtype, device),
            "ln_h": torch.zeros((D,), dtype=dtype, device=device),
            "ln_e": torch.zeros((D,), dtype=dtype, device=device),
            "block": _layer_init(cfg, _MTP_SPEC, generator, dtype, device),
        }
    return params


def group_params(cfg: ModelConfig, params: Params) -> Params:
    """The training layout of ``params``: the per-layer dicts stacked into
    one dict per ``layer_groups`` entry, each leaf with a leading ``count``
    axis (a group of one included), as the reference's tree."""
    layers = params["layers"]
    groups, i = [], 0
    for _, count in layer_groups(cfg):
        groups.append(_stack(layers[i:i + count]))
        i += count
    out = {k: v for k, v in params.items() if k != "layers"}
    out["groups"] = groups
    return out


def _stack(dicts):
    if isinstance(dicts[0], dict):
        return {k: _stack([d[k] for d in dicts]) for k in dicts[0]}
    return torch.stack(dicts)


def _unstack(tree, count: int):
    if isinstance(tree, dict):
        per = {k: _unstack(v, count) for k, v in tree.items()}
        return [{k: per[k][i] for k in tree} for i in range(count)]
    if tree.shape[0] != count:
        raise ValueError(f"a group leaf has leading axis {tree.shape[0]}, "
                         f"expected {count}")
    return list(tree.unbind(0))


def layer_params(cfg: ModelConfig, params: Params) -> List[Params]:
    """One parameter dict per layer in plan order, from either layout (for
    the training layout, views of the stacked leaves: one ``unbind`` a
    leaf, so the backward stacks each leaf's gradient once)."""
    if "layers" in params:
        return params["layers"]
    groups = layer_groups(cfg)
    if len(params["groups"]) != len(groups):
        raise ValueError(f"{len(params['groups'])} groups, the config has "
                         f"{len(groups)}")
    out: List[Params] = []
    for (_, count), gp in zip(groups, params["groups"]):
        out.extend(_unstack(gp, count))
    return out


# =========================================================================== #
# caches                                                                       #
# =========================================================================== #
def _block_cache(cfg: ModelConfig, spec: BlockSpec, B: int, S: int, dtype,
                 device) -> Dict[str, torch.Tensor]:
    """One layer's ``mix`` cache.  The int8 layout exists for attention KV
    only (:func:`blocks.attn_cache`: int8 values, fp32 scales): recurrent
    caches and MLA latents stay bf16 under an int8 request, as the
    reference's ``_block_cache`` keeps them."""
    alt = torch.bfloat16 if dtype == torch.int8 else dtype
    if spec.kind == ATTN:
        return blocks.attn_cache(cfg, B, S, dtype, device)
    if spec.kind == LOCAL_ATTN:
        return blocks.attn_cache(cfg, B, min(S, cfg.window), dtype, device)
    if spec.kind == MLA:
        return blocks.mla_cache(cfg, B, S, alt, device)
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
    quantized KV layout and keeps the other caches bf16
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
    """One layer: (h, aux), aux the layer's MoE auxiliary loss, or None
    for a layer without one (the reference adds a zero for it)."""
    if spec.kind == ATTN:
        h, _ = blocks.attn_apply(cfg, p["mix"], h, mode, cache, pos,
                                 causal=cfg.causal)
    elif spec.kind == LOCAL_ATTN:
        h, _ = blocks.attn_apply(cfg, p["mix"], h, mode, cache, pos,
                                 window=cfg.window)
    elif spec.kind == MLA:
        h, _ = blocks.mla_apply(cfg, p["mix"], h, mode, cache, pos)
    elif spec.kind == RWKV6:      # owns its channel mix
        h, _ = blocks.rwkv6_apply(cfg, p["mix"], h, mode, cache, pos)
        return h, None
    elif spec.kind == RGLRU:
        h, _ = blocks.rglru_apply(cfg, p["mix"], h, mode, cache, pos)
    else:
        raise blocks.not_ported(spec.kind)
    if spec.mlp == MOE:
        return moe.moe_apply(cfg, p["mlp"], h)
    return blocks.mlp_block_apply(cfg, p["mlp"], h), None


def forward(cfg: ModelConfig, params: Params, h, mode: str, caches=None,
            pos=0, remat: bool = False):
    """Backbone over input embeddings h (B, T, D), ``mode`` "train",
    "prefill" or "decode".  Returns (h, caches, aux): the caches, when
    given, are written in place; aux is the MoE auxiliary loss summed over
    the layers in order (a 0-d fp32 tensor, zero for a dense stack).
    ``remat`` recomputes each layer in the backward instead of keeping its
    activations (``torch.utils.checkpoint``, one call a layer, as the
    reference's ``jax.checkpoint`` of a layer)."""
    remat = remat and torch.is_grad_enabled()
    total = torch.zeros((), dtype=torch.float32, device=h.device)
    for i, (spec, p) in enumerate(zip(layer_plan(cfg),
                                      layer_params(cfg, params))):
        cache = caches[i]["mix"] if caches is not None else None
        if remat:
            h, aux = checkpoint(_apply_block, cfg, spec, p, h, mode, cache,
                                pos, use_reentrant=False)
        else:
            h, aux = _apply_block(cfg, spec, p, h, mode, cache, pos)
        if aux is not None:
            total = total + aux
    h = norm(h, params["final_norm"], cfg.norm_kind, cfg.norm_eps)
    return h, caches, total


def embed_tokens(cfg: ModelConfig, params: Params, tokens):
    return params["embed"][tokens]


def logits_fn(cfg: ModelConfig, params: Params, h):
    w = params["embed"].T if cfg.tie_embeddings else params["head"]
    return h @ w


# =========================================================================== #
# losses                                                                       #
# =========================================================================== #
def _xent(logits, labels, mask=None):
    """Mean next-token cross-entropy in fp32.  logits: (B, T, V); labels:
    (B, T) integer; mask: (B, T) weights, or None."""
    lf = logits.float()
    lse = torch.logsumexp(lf, dim=-1)
    gold = torch.gather(lf, -1, labels[..., None].long())[..., 0]
    nll = lse - gold
    if mask is not None:
        return (nll * mask).sum() / torch.clamp(mask.sum(), min=1.0)
    return nll.mean()


def _mtp_loss(cfg: ModelConfig, params: Params, h, tokens):
    """DeepSeek MTP: one extra depth predicting token t+2 from
    [norm(h_t); norm(emb(tok_{t+1}))]."""
    m = params["mtp"]
    T = h.shape[1]
    h_in = norm(h[:, :T - 2], m["ln_h"], cfg.norm_kind, cfg.norm_eps)
    e_in = norm(embed_tokens(cfg, params, tokens[:, 1:T - 1]), m["ln_e"],
                cfg.norm_kind, cfg.norm_eps)
    hm = torch.cat([h_in, e_in], dim=-1) @ m["proj"]
    hm, _ = _apply_block(cfg, _MTP_SPEC, m["block"], hm, "train", None, 0)
    return _xent(logits_fn(cfg, params, hm), tokens[:, 2:])


def lm_loss(cfg: ModelConfig, params: Params, batch, remat: bool = True):
    """Causal-LM training loss: ``batch["tokens"]`` (B, T) integer.
    Returns ``(loss, metrics)``: loss = xent + aux (+ ``mtp_coef`` * mtp),
    metrics ``{"xent", "aux"}`` and ``"mtp"`` for an MTP config; ``aux``
    is the MoE auxiliary loss, a 0-d fp32 zero for a dense stack."""
    _check_served(cfg)
    tokens = batch["tokens"]
    h = embed_tokens(cfg, params, tokens)
    h, _, aux = forward(cfg, params, h, "train", remat=remat)
    logits = logits_fn(cfg, params, h[:, :-1])
    loss = _xent(logits, tokens[:, 1:])
    metrics = {"xent": loss, "aux": aux}
    loss = loss + aux
    if cfg.mtp:
        mtp = _mtp_loss(cfg, params, h, tokens)
        metrics["mtp"] = mtp
        loss = loss + cfg.mtp_coef * mtp
    return loss, metrics


# =========================================================================== #
# serving                                                                      #
# =========================================================================== #
def prefill(cfg: ModelConfig, params: Params, batch, caches):
    """Process the full prompt (``batch["tokens"]``, (B, T)), fill caches,
    return last-token logits."""
    h = embed_tokens(cfg, params, batch["tokens"])
    h, caches, _ = forward(cfg, params, h, "prefill", caches=caches)
    return logits_fn(cfg, params, h[:, -1]), caches


def decode_step(cfg: ModelConfig, params: Params, tokens, caches, pos):
    """One decode step.  tokens: (B,) int; pos: an int or a (B,) integer
    tensor of per-request positions."""
    h = embed_tokens(cfg, params, tokens[:, None])
    h, caches, _ = forward(cfg, params, h, "decode", caches=caches, pos=pos)
    return logits_fn(cfg, params, h[:, 0]), caches
