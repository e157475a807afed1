"""Mixture-of-Experts layer: shared experts + routed top-k with sort-based
dispatch (a port of the JAX package's ``models/moe.py``).

Tokens are sorted by assigned expert and scattered into a dense (E, C, D)
buffer with per-expert capacity C = ceil(cf * T * k / n_experts); expert
compute is then one batched product over experts, (E, C, D) x (E, D, F),
whose work is the *active* parameters' (plus the capacity-factor slack),
while its weight reads are every expert's.  Tokens over capacity are
dropped (Switch-style; the auxiliary loss keeps the router balanced).

The reference computes dispatch and expert products in XLA, outside any
Pallas kernel, so every step here is a PyTorch operation.  Where the
reference scatter-adds each token's k weighted rows, the port gathers them
back in the same order (by position in the expert sort) and adds them one
after the other: the same function, and deterministic on the card, where
``index_add_`` adds with atomics in a run-dependent order.

The reference's ``ep_spec`` argument (a GSPMD sharding hint for the
dispatch buffer) steers only XLA's partitioner, so :func:`moe_apply` does
not take it; the port's dry run reads the same layout from its plan
(``launch.shardings.Plan.ep_spec``).  Routing groups (:func:`set_groups`)
are kept: they change which tokens compete for capacity.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ..kernels import meta_cost
from .config import ModelConfig
from .layers import norm, uinit

__all__ = ["moe_init", "moe_axes", "moe_apply", "router_probs", "capacity",
           "set_groups", "get_groups"]

# Number of independent routing groups: each routes its own tokens, with
# its own capacity (the reference's per-data-rank dispatch).
_GROUPS = 1


def set_groups(g: int) -> None:
    global _GROUPS
    _GROUPS = max(1, int(g))


def get_groups() -> int:
    return _GROUPS


def moe_init(cfg: ModelConfig, gen, dtype, device):
    """One MoE MLP's parameters.  Padded ("dead") experts widen the router
    and the expert leaves to E = n_experts + n_experts_pad; the router
    never selects them (masked logits)."""
    D, Fe = cfg.d_model, cfg.d_expert
    E = cfg.n_experts + cfg.n_experts_pad

    def u(shape, scale=None):
        return uinit(gen, shape, scale, dtype, device)
    p = {
        "ln": torch.zeros((D,), dtype=dtype, device=device),
        "router": u((D, E), 0.02),
        "wg": u((E, D, Fe), 1 / math.sqrt(D)),
        "wu": u((E, D, Fe), 1 / math.sqrt(D)),
        "wd": u((E, Fe, D), 1 / math.sqrt(Fe)),
    }
    if cfg.d_shared:
        p.update(swg=u((D, cfg.d_shared)), swu=u((D, cfg.d_shared)),
                 swd=u((cfg.d_shared, D)))
        if cfg.shared_gate:
            p["sgate"] = u((D, 1), 0.02)
    return p


def moe_axes(cfg: ModelConfig):
    """The logical axes of :func:`moe_init`'s leaves."""
    a = {"ln": ("d_model",), "router": ("d_model", None),
         "wg": ("experts", "d_model", "d_expert"),
         "wu": ("experts", "d_model", "d_expert"),
         "wd": ("experts", "d_expert", "d_model")}
    if cfg.d_shared:
        a.update(swg=("d_model", "d_shared"), swu=("d_model", "d_shared"),
                 swd=("d_shared", "d_model"))
        if cfg.shared_gate:
            a["sgate"] = ("d_model", None)
    return a


def router_probs(cfg: ModelConfig, p, x):
    """The router over x (B, T, D): the normed rows (B*T, D), their fp32
    logits (padded experts at -1e9) and the softmax probabilities, as
    :func:`moe_apply` computes them."""
    B, T, D = x.shape
    rows = norm(x, p["ln"], cfg.norm_kind, cfg.norm_eps).reshape(B * T, D)
    logits = (rows @ p["router"]).float()
    if cfg.n_experts_pad:
        pad = torch.arange(logits.shape[-1], device=x.device) >= cfg.n_experts
        logits = logits.masked_fill(pad, -1e9)
    return rows, logits, torch.softmax(logits, dim=-1)


def capacity(cfg: ModelConfig, Tg: int) -> int:
    """Rows an expert keeps from a group of Tg tokens: ceil(cf * Tg * k /
    n_experts), at least 1, counting the real experts only (padded ones
    receive no tokens), in Python floats as the reference computes it."""
    return max(1, int(math.ceil(cfg.capacity_factor * Tg * cfg.top_k
                                / cfg.n_experts)))


def _dispatch_compute(cfg: ModelConfig, p, x3d, probs):
    """x3d: (G, Tg, D); probs: (G, Tg, E).  Returns the routed output
    (G, Tg, D): per group, tokens sorted by expert into a (E, C, D) buffer
    whose capacity C counts the real experts only."""
    G, Tg, D = x3d.shape
    E = cfg.n_experts + cfg.n_experts_pad     # the buffer spans padded experts
    k = cfg.top_k
    C = capacity(cfg, Tg)
    dev = x3d.device

    topv, topi = torch.topk(probs, k, dim=-1)                # (G, Tg, k)
    topv = topv / torch.clamp(topv.sum(-1, keepdim=True), min=1e-9)
    flat_e = topi.reshape(G, Tg * k)
    order = torch.argsort(flat_e, dim=1, stable=True)
    sorted_e = torch.gather(flat_e, 1, order)
    seg_start = torch.searchsorted(
        sorted_e, torch.arange(E, device=dev).expand(G, E).contiguous())
    pos_in_e = (torch.arange(Tg * k, device=dev)[None]
                - torch.gather(seg_start, 1, sorted_e))
    keep = pos_in_e < C
    slot = torch.where(keep, sorted_e * C + pos_in_e,
                       torch.full_like(pos_in_e, E * C))    # E*C: dropped
    token_of = order // k

    # scatter into E*C rows and a drop row past them, then cut it off
    rows = torch.gather(x3d, 1, token_of[..., None].expand(G, Tg * k, D))
    gi = torch.arange(G, device=dev)[:, None].expand(G, Tg * k)
    buf = x3d.new_zeros((G, E * C + 1, D)).index_put((gi, slot), rows)
    buf = buf[:, :E * C].reshape(G, E, C, D)

    h_g = F.silu(torch.einsum("gecd,edf->gecf", buf, p["wg"]))
    h_u = torch.einsum("gecd,edf->gecf", buf, p["wu"])
    out = torch.einsum("gecf,efd->gecd", h_g * h_u, p["wd"])
    out = out.reshape(G, E * C, D)

    # each token's k entries, in the order the reference adds them (their
    # positions in the expert sort, ascending)
    by_token = torch.argsort(token_of, dim=1, stable=True)
    slot_t = torch.gather(slot, 1, by_token)
    keep_t = torch.gather(keep, 1, by_token)
    w_t = torch.gather(topv.reshape(G, Tg * k), 1,
                       torch.gather(order, 1, by_token))
    got = torch.gather(out, 1, torch.clamp(slot_t, max=E * C - 1)[..., None]
                       .expand(G, Tg * k, D))
    got = got.masked_fill(~keep_t[..., None], 0.0)
    got = (got * w_t[..., None].to(got.dtype)).reshape(G, Tg, k, D)
    y = got[:, :, 0]
    for j in range(1, k):
        y = y + got[:, :, j]
    return y


def moe_apply(cfg: ModelConfig, p, x):
    """x: (B, T, D) -> (x + MoE(x), aux).  aux is the load-balance loss
    (over the real experts) plus the router z-loss, a 0-d fp32 tensor."""
    B, T, D = x.shape
    x2d, logits, probs = router_probs(cfg, p, x)
    G = _GROUPS if (B * T) % _GROUPS == 0 else 1
    with meta_cost.region("moe_dispatch"):     # tagged for the dry run
        y = _dispatch_compute(cfg, p, x2d.reshape(G, (B * T) // G, D),
                              probs.reshape(G, (B * T) // G, -1))
    y = y.reshape(B * T, D)

    if cfg.d_shared:
        s_out = (F.silu(x2d @ p["swg"]) * (x2d @ p["swu"])) @ p["swd"]
        if cfg.shared_gate:
            s_out = s_out * torch.sigmoid(x2d @ p["sgate"])
        y = y + s_out

    # Switch-style load balance + z-loss
    E = cfg.n_experts
    top1 = torch.argmax(probs, dim=-1)
    frac_tokens = (top1[:, None] == torch.arange(E, device=x.device)
                   ).float().mean(0)
    frac_probs = probs[..., :E].mean(0)            # real experts only
    lb = E * torch.sum(frac_tokens * frac_probs)
    zl = torch.mean(torch.square(torch.logsumexp(logits, dim=-1)))
    aux = cfg.router_aux_coef * lb + cfg.router_z_coef * zl
    return x + y.reshape(B, T, D), aux
