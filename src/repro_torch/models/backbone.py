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
layout.  Caches are a list of per-layer dicts in plan order: ``"mix"``,
and ``"cross"`` (the encoder's K/V) for an encoder-decoder.  DeepSeek's
multi-token-prediction depth (``params["mtp"]``, one unstacked attention
block) sits beside the layers in both layouts, as in the reference, and so
does Whisper's encoder (``params["enc"]``: ``"layers"`` or ``"groups"``,
one group of ``encoder_layers``, and its ``"final_norm"``).

``forward`` returns the MoE auxiliary loss beside the hidden states, as
the reference's does; ``lm_loss`` adds it (and the MTP loss) to the
cross-entropy.  The frontends are stubs, as in the reference: an
encoder-decoder takes frame embeddings ``enc_embeds`` (B, S_enc, D)
through :func:`encode`; a vision config takes patch embeddings
``vision_embeds`` (B, Nv, D), which replace the embeddings of the first Nv
tokens.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List

import torch
from torch.utils.checkpoint import checkpoint

from ..device import resolve_device
from . import blocks, moe
from .config import (ATTN, DENSE, LOCAL_ATTN, MLA, MOE, RGLRU, RWKV6,
                     BlockSpec, ModelConfig, layer_groups, layer_plan)
from .layers import norm, sinusoid_pos, uinit

__all__ = ["init_params", "param_axes", "param_shapes", "group_params",
           "layer_params", "init_cache", "cache_shapes", "slot_view",
           "encode", "forward", "embed_tokens", "logits_fn", "lm_loss",
           "prefill", "decode_step"]

Params = Dict[str, Any]

#: the MTP depth's block and the encoder's layers, whatever the stack's
#: kinds (an attention layer with a dense MLP, as the reference's)
_MTP_SPEC = _ENC_SPEC = BlockSpec(ATTN, DENSE)


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
        raise ValueError(spec.kind)
    layer = {"mix": mix}
    if spec.cross_attn:
        layer["cross"] = blocks.attn_init(cfg, gen, dtype, device, cross=True)
    layer["mlp"] = (moe.moe_init(cfg, gen, dtype, device) if spec.mlp == MOE
                    else blocks.mlp_block_init(cfg, gen, dtype, device))
    return layer


def init_params(cfg: ModelConfig, generator: torch.Generator,
                dtype=torch.float32, device="cuda") -> Params:
    """Scaled-uniform parameters (as the reference's ``uinit``), drawn in
    fp32 from ``generator`` on its own device, then cast to ``dtype`` on
    ``device``.  They cannot reproduce ``jax.random``'s bits: to compare
    with the reference, carry its parameters across with
    :func:`repro_torch.models.convert.params_from_reference`."""
    device = resolve_device(device)
    D, V = cfg.d_model, cfg.vocab
    params: Params = {"embed": uinit(generator, (V, D), 0.02, dtype, device)}
    params["layers"] = [_layer_init(cfg, spec, generator, dtype, device)
                        for spec in layer_plan(cfg)]
    params["final_norm"] = torch.zeros((D,), dtype=dtype, device=device)
    if not cfg.tie_embeddings:
        params["head"] = uinit(generator, (D, V), 0.02, dtype, device)
    if cfg.is_encdec:
        params["enc"] = {
            "layers": [_layer_init(cfg, _ENC_SPEC, generator, dtype, device)
                       for _ in range(cfg.encoder_layers)],
            "final_norm": torch.zeros((D,), dtype=dtype, device=device)}
    if cfg.mtp:                   # one extra depth: an attention block
        params["mtp"] = {
            "proj": uinit(generator, (2 * D, D), None, dtype, device),
            "ln_h": torch.zeros((D,), dtype=dtype, device=device),
            "ln_e": torch.zeros((D,), dtype=dtype, device=device),
            "block": _layer_init(cfg, _MTP_SPEC, generator, dtype, device),
        }
    return params


def _layer_axes(cfg: ModelConfig, spec: BlockSpec) -> Params:
    """The logical axes of one :func:`_layer_init` dict."""
    if spec.kind in (ATTN, LOCAL_ATTN):
        mix = blocks.attn_axes(cfg)
    elif spec.kind == MLA:
        mix = blocks.mla_axes(cfg)
    elif spec.kind == RWKV6:
        return {"mix": blocks.rwkv6_axes(cfg)}
    elif spec.kind == RGLRU:
        mix = blocks.rglru_axes(cfg)
    else:
        raise ValueError(spec.kind)
    layer = {"mix": mix}
    if spec.cross_attn:
        layer["cross"] = blocks.attn_axes(cfg, cross=True)
    layer["mlp"] = (moe.moe_axes(cfg) if spec.mlp == MOE
                    else blocks.mlp_block_axes(cfg))
    return layer


def _stacked_axes(tree):
    return {k: _stacked_axes(v) if isinstance(v, dict) else ("layers",) + v
            for k, v in tree.items()}


def param_axes(cfg: ModelConfig) -> Params:
    """The logical axes of every parameter, a tuple of names a leaf, in
    the training layout (:func:`group_params`: a ``"layers"`` axis in front
    of every group leaf), as the reference's ``param_axes``.  Nothing is
    allocated."""
    axes: Params = {
        "embed": ("vocab", "d_model"),
        "groups": [_stacked_axes(_layer_axes(cfg, spec))
                   for spec, _ in layer_groups(cfg)],
        "final_norm": ("d_model",)}
    if not cfg.tie_embeddings:
        axes["head"] = ("d_model", "vocab")
    if cfg.is_encdec:
        axes["enc"] = {"groups": [_stacked_axes(_layer_axes(cfg, _ENC_SPEC))],
                       "final_norm": ("d_model",)}
    if cfg.mtp:
        axes["mtp"] = {"proj": (None, "d_model"), "ln_h": ("d_model",),
                       "ln_e": ("d_model",),
                       "block": _layer_axes(cfg, _MTP_SPEC)}
    return axes


def param_shapes(cfg: ModelConfig, dtype=torch.float32) -> Params:
    """The parameters in the training layout as ``meta`` tensors: shapes
    and dtypes at any size, no data (the reference's ``eval_shape`` of its
    ``init_params``)."""
    return group_params(cfg, init_params(cfg, torch.Generator(), dtype=dtype,
                                         device="meta"))


def group_params(cfg: ModelConfig, params: Params) -> Params:
    """The training layout of ``params``: the per-layer dicts stacked into
    one dict per ``layer_groups`` entry, each leaf with a leading ``count``
    axis (a group of one included), as the reference's tree; the encoder's
    layers into its one group."""
    layers = params["layers"]
    groups, i = [], 0
    for _, count in layer_groups(cfg):
        groups.append(_stack(layers[i:i + count]))
        i += count
    out = {k: v for k, v in params.items() if k != "layers"}
    out["groups"] = groups
    if "enc" in params and "layers" in params["enc"]:
        out["enc"] = {"groups": [_stack(params["enc"]["layers"])],
                      "final_norm": params["enc"]["final_norm"]}
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


def _enc_layers(cfg: ModelConfig, enc: Params) -> List[Params]:
    """The encoder's per-layer dicts, from either layout."""
    if "layers" in enc:
        return enc["layers"]
    return _unstack(enc["groups"][0], cfg.encoder_layers)


# =========================================================================== #
# caches                                                                       #
# =========================================================================== #
def _block_cache(cfg: ModelConfig, spec: BlockSpec, B: int, S: int,
                 S_enc: int, dtype, device) -> Dict[str, Dict]:
    """One layer's caches: ``mix``, and ``cross`` (``S_enc`` frames) for a
    decoder layer of an encoder-decoder.  The int8 layout exists for
    attention KV only (:func:`blocks.attn_cache`: int8 values, fp32
    scales): recurrent caches, MLA latents and the cross K/V stay bf16
    under an int8 request, as the reference's ``_block_cache`` keeps
    them."""
    alt = torch.bfloat16 if dtype == torch.int8 else dtype
    if spec.kind == ATTN:
        mix = blocks.attn_cache(cfg, B, S, dtype, device)
    elif spec.kind == LOCAL_ATTN:
        mix = blocks.attn_cache(cfg, B, min(S, cfg.window), dtype, device)
    elif spec.kind == MLA:
        mix = blocks.mla_cache(cfg, B, S, alt, device)
    elif spec.kind == RWKV6:
        mix = blocks.rwkv6_cache(cfg, B, S, alt, device)
    elif spec.kind == RGLRU:
        mix = blocks.rglru_cache(cfg, B, S, alt, device)
    else:
        raise ValueError(spec.kind)
    c = {"mix": mix}
    if spec.cross_attn:
        c["cross"] = blocks.cross_cache(cfg, B, S_enc, alt, device)
    return c


def init_cache(cfg: ModelConfig, B: int, S: int, S_enc: int = 0,
               dtype=torch.bfloat16, device="cuda"
               ) -> List[Dict[str, Dict[str, torch.Tensor]]]:
    """Decode caches, one dict per layer in plan order (``"mix"``, and
    ``"cross"`` of ``S_enc`` frames for an encoder-decoder).  bf16 by
    default, as the reference; the RG-LRU state ``h`` and the RWKV6 state
    ``s`` stay fp32.  An int8 request gives attention layers the quantized
    KV layout and keeps the other caches bf16 (:func:`_block_cache`).
    A local-attention layer's cache is its window, ``min(S, window)``."""
    device = resolve_device(device)
    return [_block_cache(cfg, spec, B, S, S_enc, dtype, device)
            for spec in layer_plan(cfg)]


def cache_shapes(cfg: ModelConfig, B: int, S: int, S_enc: int = 0,
                 dtype=torch.bfloat16) -> Params:
    """The caches of :func:`init_cache` as ``meta`` tensors in the
    reference's layout: ``{"groups": [...]}``, one dict a ``layer_groups``
    entry, every leaf stacked ``(count, ...)``.  ``layer_params(cfg,
    caches)`` gives the per-layer views the forward takes."""
    meta = torch.device("meta")
    groups = []
    for spec, count in layer_groups(cfg):
        one = _block_cache(cfg, spec, B, S, S_enc, dtype, meta)
        groups.append({part: {k: v.new_empty((count,) + v.shape)
                              for k, v in c.items()}
                       for part, c in one.items()})
    return {"groups": groups}


def slot_view(caches, slot: int):
    """The caches of batch row ``slot`` as views (batch size 1): writing
    them writes the full caches."""
    return [{part: {k: v[slot:slot + 1] for k, v in c[part].items()}
             for part in c} for c in caches]


# =========================================================================== #
# forward                                                                      #
# =========================================================================== #
def _apply_block(cfg: ModelConfig, spec: BlockSpec, p, h, mode, cache, pos,
                 enc_out=None):
    """One layer (``cache``: its ``{"mix", "cross"}`` dict, or None):
    (h, aux), aux the layer's MoE auxiliary loss, or None for a layer
    without one (the reference adds a zero for it)."""
    mix_c = cache["mix"] if cache is not None else None
    if spec.kind == ATTN:
        h, _ = blocks.attn_apply(cfg, p["mix"], h, mode, mix_c, pos,
                                 causal=cfg.causal)
    elif spec.kind == LOCAL_ATTN:
        h, _ = blocks.attn_apply(cfg, p["mix"], h, mode, mix_c, pos,
                                 window=cfg.window)
    elif spec.kind == MLA:
        h, _ = blocks.mla_apply(cfg, p["mix"], h, mode, mix_c, pos)
    elif spec.kind == RWKV6:      # owns its channel mix
        h, _ = blocks.rwkv6_apply(cfg, p["mix"], h, mode, mix_c, pos)
        return h, None
    elif spec.kind == RGLRU:
        h, _ = blocks.rglru_apply(cfg, p["mix"], h, mode, mix_c, pos)
    else:
        raise ValueError(spec.kind)
    if spec.cross_attn:
        h, _ = blocks.cross_apply(cfg, p["cross"], h, mode,
                                  cache["cross"] if cache is not None
                                  else None, enc_out)
    if spec.mlp == MOE:
        return moe.moe_apply(cfg, p["mlp"], h)
    return blocks.mlp_block_apply(cfg, p["mlp"], h), None


def _run_layers(cfg: ModelConfig, specs, layers, h, mode, caches, pos,
                enc_out, remat):
    """The layers in order; (h, aux summed in order)."""
    remat = remat and torch.is_grad_enabled()
    total = torch.zeros((), dtype=torch.float32, device=h.device)
    for i, (spec, p) in enumerate(zip(specs, layers)):
        cache = caches[i] if caches is not None else None
        if remat:
            h, aux = checkpoint(_apply_block, cfg, spec, p, h, mode, cache,
                                pos, enc_out, use_reentrant=False)
        else:
            h, aux = _apply_block(cfg, spec, p, h, mode, cache, pos, enc_out)
        if aux is not None:
            total = total + aux
    return h, total


def encode(cfg: ModelConfig, params: Params, enc_embeds, remat: bool = False):
    """Whisper-style encoder over stub frame embeddings (B, S, D):
    sinusoidal positions added, then ``encoder_layers`` bidirectional
    attention layers (with RoPE, as the reference's ``attn_apply`` applies
    it) and the encoder's final norm.  The frames are cast to the
    parameters' dtype first (the reference promotes bf16 weights to the
    frames' fp32 instead; the kernels take bf16 on the card)."""
    dtype = params["enc"]["final_norm"].dtype
    x = enc_embeds.to(dtype)
    h = x + sinusoid_pos(x.shape[1], cfg.d_model, device=x.device).to(dtype)
    enc_cfg = dataclasses.replace(cfg, causal=False)
    layers = _enc_layers(cfg, params["enc"])
    h, _ = _run_layers(enc_cfg, [_ENC_SPEC] * len(layers), layers, h,
                       "train", None, 0, None, remat)
    return norm(h, params["enc"]["final_norm"], cfg.norm_kind, cfg.norm_eps)


def forward(cfg: ModelConfig, params: Params, h, mode: str, caches=None,
            pos=0, enc_out=None, remat: bool = False):
    """Backbone over input embeddings h (B, T, D), ``mode`` "train",
    "prefill" or "decode"; ``enc_out`` the encoder's output for an
    encoder-decoder's train and prefill.  Returns (h, caches, aux): the
    caches, when given, are written in place; aux is the MoE auxiliary loss
    summed over the layers in order (a 0-d fp32 tensor, zero for a dense
    stack).  ``remat`` recomputes each layer in the backward instead of
    keeping its activations (``torch.utils.checkpoint``, one call a layer,
    as the reference's ``jax.checkpoint`` of a layer)."""
    h, total = _run_layers(cfg, layer_plan(cfg), layer_params(cfg, params),
                           h, mode, caches, pos, enc_out, remat)
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


def _frontends(cfg: ModelConfig, params: Params, batch, remat: bool):
    """(input embeddings, encoder output or None, vision patches Nv or 0):
    the tokens' embeddings with the first Nv replaced by
    ``batch["vision_embeds"]`` for a vision config, and ``encode`` of
    ``batch["enc_embeds"]`` for an encoder-decoder."""
    h = embed_tokens(cfg, params, batch["tokens"])
    enc_out = (encode(cfg, params, batch["enc_embeds"], remat=remat)
               if cfg.is_encdec else None)
    nv = 0
    if cfg.frontend == "vision":
        ve = batch["vision_embeds"].to(h.dtype)          # (B, Nv, D)
        nv = ve.shape[1]
        h = torch.cat([ve, h[:, nv:]], dim=1)
    return h, enc_out, nv


def lm_loss(cfg: ModelConfig, params: Params, batch, remat: bool = True):
    """Causal-LM training loss: ``batch["tokens"]`` (B, T) integer, with
    ``"enc_embeds"`` for an encoder-decoder and ``"vision_embeds"`` (B, Nv,
    D) for a vision config (their first Nv - 1 targets left out of the
    mean, as the reference's).  Returns ``(loss, metrics)``: loss = xent +
    aux (+ ``mtp_coef`` * mtp), metrics ``{"xent", "aux"}`` and ``"mtp"``
    for an MTP config; ``aux`` is the MoE auxiliary loss, a 0-d fp32 zero
    for a dense stack."""
    tokens = batch["tokens"]
    h, enc_out, nv = _frontends(cfg, params, batch, remat)
    mask = None
    if nv:
        B, T = tokens.shape
        mask = torch.cat([torch.zeros((B, nv - 1), device=h.device),
                          torch.ones((B, T - nv), device=h.device)], dim=1)
    h, _, aux = forward(cfg, params, h, "train", enc_out=enc_out,
                        remat=remat)
    logits = logits_fn(cfg, params, h[:, :-1])
    loss = _xent(logits, tokens[:, 1:], mask)
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
    """Process the full prompt (``batch["tokens"]``, (B, T), with the
    frontends' ``enc_embeds`` / ``vision_embeds`` as in :func:`lm_loss`),
    fill caches, return last-token logits."""
    h, enc_out, _ = _frontends(cfg, params, batch, False)
    h, caches, _ = forward(cfg, params, h, "prefill", caches=caches,
                           enc_out=enc_out)
    return logits_fn(cfg, params, h[:, -1]), caches


def decode_step(cfg: ModelConfig, params: Params, tokens, caches, pos):
    """One decode step.  tokens: (B,) int; pos: an int or a (B,) integer
    tensor of per-request positions."""
    h = embed_tokens(cfg, params, tokens[:, None])
    h, caches, _ = forward(cfg, params, h, "decode", caches=caches, pos=pos)
    return logits_fn(cfg, params, h[:, 0]), caches
