"""Per-kind sequence-mixing blocks of the serving path: init / apply / cache
for one layer (a port of the JAX package's ``models/blocks.py``).

Block contract
--------------
``<kind>_init(cfg, gen, dtype, device) -> params`` — a dict of tensors for
ONE layer, under the reference's names and layouts.

``<kind>_apply(cfg, p, x, mode, cache, pos) -> (y, cache)`` — ``mode`` is
"train" | "prefill" | "decode"; x is (B, T, D) ((B, 1, D) for decode).
``pos`` is an int (tokens already in context), or a (B,) integer tensor of
per-request positions in decode.  Where the reference returns a new cache,
the port writes the cache it was given in place and returns it, so a
caller may pass views of a larger cache (one serving slot) and see them
filled.

``<kind>_cache(cfg, B, S, dtype, device)`` — zeroed per-layer cache dict.

Ported: softmax attention (full and sliding-window), the RG-LRU recurrent
block and the dense MLP block.  MLA, RWKV6, cross-attention and MoE come
with later slices (``ROADMAP.md``) and raise ``NotImplementedError``.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ..kernels import ops as kops
from .config import MLA, MOE, RWKV6, ModelConfig
from .layers import mlp_apply, mlp_init, norm, rope, uinit

__all__ = [
    "attn_init", "attn_cache", "attn_apply",
    "rglru_init", "rglru_cache", "rglru_apply",
    "mlp_block_init", "mlp_block_apply", "not_ported",
]

_LATER = {
    MLA: "MLA (DeepSeek) blocks come with the other families' slice",
    RWKV6: "RWKV6 blocks come with the next slice (RWKV6-7B serving, wkv6)",
    MOE: "MoE MLPs come with the other families' slice",
    "cross": "cross-attention (Whisper) comes with the other families' slice",
    "int8": "the int8 KV-cache layout comes with a later slice",
}


def not_ported(what: str) -> NotImplementedError:
    """The error for a block or layout a later slice ports."""
    return NotImplementedError(
        f"{_LATER.get(what, what)} of the PyTorch port; see ROADMAP.md")


def _zeros(shape, dtype, device):
    return torch.zeros(shape, dtype=dtype, device=device)


# =========================================================================== #
# softmax attention (full + local window)                                      #
# =========================================================================== #
def attn_init(cfg: ModelConfig, gen, dtype, device):
    D, H, Hkv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    p = {
        "ln": _zeros((D,), dtype, device),
        "wq": uinit(gen, (D, H, hd), 1 / math.sqrt(D), dtype, device),
        "wk": uinit(gen, (D, Hkv, hd), 1 / math.sqrt(D), dtype, device),
        "wv": uinit(gen, (D, Hkv, hd), 1 / math.sqrt(D), dtype, device),
        "wo": uinit(gen, (H, hd, D), 1 / math.sqrt(H * hd), dtype, device),
    }
    if cfg.qk_norm:
        p["qn"] = _zeros((hd,), dtype, device)
        p["kn"] = _zeros((hd,), dtype, device)
    return p


def attn_cache(cfg: ModelConfig, B: int, S: int, dtype, device):
    if dtype == torch.int8:
        raise not_ported("int8")
    shape = (B, S, cfg.n_kv_heads, cfg.head_dim)
    return {"k": _zeros(shape, dtype, device), "v": _zeros(shape, dtype, device)}


def _qkv(cfg: ModelConfig, p, x, positions):
    B, T, D = x.shape
    q = (x @ p["wq"].reshape(D, -1)).reshape(B, T, cfg.n_heads, -1)
    k = (x @ p["wk"].reshape(D, -1)).reshape(B, T, cfg.n_kv_heads, -1)
    v = (x @ p["wv"].reshape(D, -1)).reshape(B, T, cfg.n_kv_heads, -1)
    if cfg.qk_norm and "qn" in p:
        q = norm(q, p["qn"], "rmsnorm", cfg.norm_eps)
        k = norm(k, p["kn"], "rmsnorm", cfg.norm_eps)
    return (rope(q, positions, cfg.rope_theta),
            rope(k, positions, cfg.rope_theta), v)


def attn_apply(cfg: ModelConfig, p, x, mode: str, cache, pos, *,
               window: int = 0, causal: bool = True):
    h = norm(x, p["ln"], cfg.norm_kind, cfg.norm_eps)
    B, T, D = h.shape
    wo = p["wo"].reshape(-1, D)
    if mode == "decode":
        pos_t = torch.as_tensor(pos, dtype=torch.int64, device=x.device)
        batched = pos_t.dim() == 1         # per-request positions (serving)
        positions = pos_t[:, None] if batched else pos_t.reshape(1)
        q, k, v = _qkv(cfg, p, h, positions)
        S = cache["k"].shape[1]
        # the ring slot (window > 0) or the last slot: as the reference
        slot = pos_t % S if window > 0 else torch.clamp(pos_t, max=S - 1)
        for name, val in (("k", k), ("v", v)):
            buf = cache[name]
            val = val[:, 0].to(buf.dtype)
            if batched:
                buf[torch.arange(B, device=x.device), slot] = val
            else:
                buf[:, int(slot)] = val
        o = kops.flash_decode(q[:, 0], cache["k"], cache["v"], pos_t)
        y = (o.reshape(B, -1) @ wo)[:, None]
        return x + y, cache

    positions = pos + torch.arange(T, device=x.device)
    q, k, v = _qkv(cfg, p, h, positions)
    o = kops.flash_attention(q, k, v, causal=causal, window=window,
                             q_offset=0)
    y = o.reshape(B, T, -1) @ wo
    if mode == "prefill" and cache is not None:
        S = cache["k"].shape[1]
        for name, val in (("k", k), ("v", v)):
            buf = cache[name]
            if T >= S:      # keep the last S tokens (ring window fully filled)
                buf.copy_(val[:, T - S:])
            else:
                buf[:, :T] = val
    return x + y, cache


# =========================================================================== #
# RG-LRU (Griffin / RecurrentGemma recurrent block)                            #
# =========================================================================== #
_CONV_W = 4
_LRU_C = 8.0


def rglru_init(cfg: ModelConfig, gen, dtype, device):
    D, W, H = cfg.d_model, cfg.lru_width, cfg.n_heads
    bw = W // H
    return {
        "ln": _zeros((D,), dtype, device),
        "w_x": uinit(gen, (D, W), None, dtype, device),
        "w_g": uinit(gen, (D, W), None, dtype, device),
        "conv_w": uinit(gen, (_CONV_W, W), 0.5, dtype, device),
        "conv_b": _zeros((W,), dtype, device),
        "rg_a": uinit(gen, (H, bw, bw), None, dtype, device),  # recurrence gate
        "rg_x": uinit(gen, (H, bw, bw), None, dtype, device),  # input gate
        "rg_a_b": _zeros((W,), dtype, device),
        "rg_x_b": _zeros((W,), dtype, device),
        "lam": torch.linspace(0.2, 0.9, W, dtype=torch.float32).to(
            device=device, dtype=dtype),
        "w_out": uinit(gen, (W, D), None, dtype, device),
    }


def rglru_cache(cfg: ModelConfig, B: int, S: int, dtype, device):
    W = cfg.lru_width
    return {"conv": _zeros((B, _CONV_W - 1, W), dtype, device),
            "h": _zeros((B, W), torch.float32, device)}


def _causal_conv(x, w, b, x_prev):
    """Depthwise causal conv, width 4.  x: (B,T,W); x_prev: (B,3,W)."""
    xx = torch.cat([x_prev.to(x.dtype), x], dim=1)
    T = x.shape[1]
    return b + sum(w[i] * xx[:, _CONV_W - 1 - i:_CONV_W - 1 - i + T]
                   for i in range(_CONV_W))


def _block_diag(x, w, b, H):
    """x: (B,T,W) -> block-diagonal linear with H blocks."""
    B, T, W = x.shape
    xh = x.reshape(B, T, H, W // H)
    return torch.einsum("bthi,hij->bthj", xh, w).reshape(B, T, W) + b


def _softplus(x):
    # jax.nn.softplus is logaddexp(x, 0) for every input; F.softplus
    # switches to x above a threshold
    return torch.logaddexp(x, torch.zeros_like(x))


def rglru_apply(cfg: ModelConfig, p, x, mode: str, cache, pos):
    B, T, D = x.shape
    W, H = cfg.lru_width, cfg.n_heads
    h_in = norm(x, p["ln"], cfg.norm_kind, cfg.norm_eps)
    xb = h_in @ p["w_x"]                                     # recurrent branch
    gb = F.gelu(h_in @ p["w_g"], approximate="tanh")         # gate branch
    conv_prev = (cache["conv"].to(xb.dtype) if cache is not None
                 else _zeros((B, _CONV_W - 1, W), xb.dtype, x.device))
    xc = _causal_conv(xb, p["conv_w"], p["conv_b"], conv_prev)
    rg = torch.sigmoid(_block_diag(xc, p["rg_a"], p["rg_a_b"], H))
    ig = torch.sigmoid(_block_diag(xc, p["rg_x"], p["rg_x_b"], H))
    log_a = -_LRU_C * _softplus(p["lam"]) * rg.float()
    a = torch.exp(log_a)
    gated_x = (ig * xc).float()
    beta = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-12))
    bt = beta * gated_x
    h0 = (cache["h"] if cache is not None
          else _zeros((B, W), torch.float32, x.device))

    h_seq, hT = kops.linear_recurrence(a, bt, h0)            # (B,T,W) fp32
    y = (gb * h_seq.to(gb.dtype)) @ p["w_out"]
    if cache is not None and mode in ("prefill", "decode"):
        tail = torch.cat([conv_prev, xb], dim=1)[:, -(_CONV_W - 1):]
        cache["conv"].copy_(tail)
        cache["h"].copy_(hT)
    return x + y, cache


# =========================================================================== #
# dense MLP block                                                              #
# =========================================================================== #
def mlp_block_init(cfg: ModelConfig, gen, dtype, device):
    p = mlp_init(gen, cfg.d_model, cfg.d_ff, cfg.mlp_act, dtype, device)
    return {"ln": _zeros((cfg.d_model,), dtype, device), **p}


def mlp_block_apply(cfg: ModelConfig, p, x):
    h = norm(x, p["ln"], cfg.norm_kind, cfg.norm_eps)
    return x + mlp_apply(p, h, cfg.mlp_act)

