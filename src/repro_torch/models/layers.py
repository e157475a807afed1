"""Primitive layers of the serving path (a port of the JAX package's
``models/layers.py``).

Attention here is the *chunked* formulation: each query chunk attends to
the full — or windowed — key range with an fp32 softmax.  It is the plain
PyTorch version behind the attention kernels (``repro_torch.kernels``): the
CPU path, and what the kernels are held against on the card.  Layouts are
the reference's: q (B, T, H, hd), k/v (B, T, Hkv, hd).
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

__all__ = [
    "uinit", "rmsnorm", "layernorm", "norm", "rope", "rope_angles",
    "sinusoid_pos", "mlp_init", "mlp_axes", "mlp_apply", "chunked_attention",
    "decode_attention",
]

_NEG_INF = -1e30


# --------------------------------------------------------------------------- #
# init                                                                         #
# --------------------------------------------------------------------------- #
def uinit(gen: torch.Generator, shape, scale: Optional[float], dtype,
          device) -> torch.Tensor:
    """Scaled-uniform (LeCun-ish) initializer; scale defaults to
    1/sqrt(fan_in).  Drawn in fp32 on the generator's device, then moved
    and cast; it cannot give ``jax.random``'s bits.  On ``meta`` (shapes
    only, for the dry run) nothing is drawn or allocated."""
    if scale is None:
        fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
        scale = 1.0 / math.sqrt(max(1, fan_in))
    on = device if torch.device(device).type == "meta" else gen.device
    t = torch.empty(shape, dtype=torch.float32, device=on)
    t.uniform_(-scale, scale, generator=gen)
    return t.to(device=device, dtype=dtype)


# --------------------------------------------------------------------------- #
# norms                                                                        #
# --------------------------------------------------------------------------- #
def rmsnorm(x, w, eps: float = 1e-6):
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps)
    return (out * (1.0 + w.float())).to(x.dtype)


def layernorm(x, w, b=None, eps: float = 1e-6):
    xf = x.float()
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.var(xf, dim=-1, keepdim=True, unbiased=False)
    out = (xf - mu) * torch.rsqrt(var + eps) * (1.0 + w.float())
    if b is not None:
        out = out + b.float()
    return out.to(x.dtype)


def norm(x, w, kind: str = "rmsnorm", eps: float = 1e-6):
    return layernorm(x, w, eps=eps) if kind == "layernorm" else rmsnorm(x, w, eps)


# --------------------------------------------------------------------------- #
# positions                                                                    #
# --------------------------------------------------------------------------- #
def rope_angles(positions: torch.Tensor, head_dim: int, theta: float):
    """(..., hd/2) angles for the given integer positions.  ``theta **
    exps`` is taken in fp64 and rounded to fp32, the correctly rounded
    power the reference's XLA gives (torch's fp32 power is a unit in the
    last place off for some exponents: 3e-5 at position 1,329 of
    Whisper's sinusoids)."""
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=positions.device) / head_dim
    freqs = 1.0 / (theta ** exps.double()).float()
    return positions.float()[..., None] * freqs


def rope(x, positions: torch.Tensor, theta: float = 1e4, *,
         heads: bool = True):
    """Rotary embedding, halves split (not interleaved).  x: (B, T, H, hd)
    when ``heads`` (default), else (B, T, hd) (MLA's shared ``k_rope``);
    positions: (T,), or (B, 1) for per-request decode positions."""
    hd = x.shape[-1]
    ang = rope_angles(positions, hd, theta)                  # (..., T, hd/2)
    if heads:
        ang = ang[..., None, :]                              # (..., T, 1, hd/2)
    while ang.dim() < x.dim():
        ang = ang[None]
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def sinusoid_pos(T: int, d: int, offset: int = 0, device="cpu"):
    """(T, d) fp32 sinusoidal positions: sines then cosines of the rotary
    angles of positions ``offset`` .. ``offset + T - 1`` (the encoder's)."""
    pos = torch.arange(offset, offset + T, dtype=torch.float32,
                       device=device)
    ang = rope_angles(pos, d, 1e4)                           # (T, d/2)
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


# --------------------------------------------------------------------------- #
# MLP                                                                          #
# --------------------------------------------------------------------------- #
def mlp_init(gen, d: int, f: int, act: str, dtype, device):
    """A gated MLP (``swiglu``, ``gelu_gated``: ``wg``, ``wu``, ``wd``) or
    the plain GELU one of Whisper (any other act: ``wi``, ``bi``, ``wo``,
    ``bo``, zero biases)."""
    if act in ("swiglu", "gelu_gated"):
        return {"wg": uinit(gen, (d, f), None, dtype, device),
                "wu": uinit(gen, (d, f), None, dtype, device),
                "wd": uinit(gen, (f, d), None, dtype, device)}
    return {"wi": uinit(gen, (d, f), None, dtype, device),
            "wo": uinit(gen, (f, d), None, dtype, device),
            "bi": torch.zeros((f,), dtype=dtype, device=device),
            "bo": torch.zeros((d,), dtype=dtype, device=device)}


def mlp_axes(act: str):
    """The logical axes of :func:`mlp_init`'s leaves."""
    if act in ("swiglu", "gelu_gated"):
        return {"wg": ("d_model", "d_ff"), "wu": ("d_model", "d_ff"),
                "wd": ("d_ff", "d_model")}
    return {"wi": ("d_model", "d_ff"), "wo": ("d_ff", "d_model"),
            "bi": ("d_ff",), "bo": ("d_model",)}


def mlp_apply(p, x, act: str):
    # jax.nn.gelu defaults to the tanh approximation
    if act in ("swiglu", "gelu_gated"):
        g = x @ p["wg"]
        g = F.silu(g) if act == "swiglu" else F.gelu(g, approximate="tanh")
        return (g * (x @ p["wu"])) @ p["wd"]
    h = F.gelu(x @ p["wi"] + p["bi"], approximate="tanh")
    return h @ p["wo"] + p["bo"]


# --------------------------------------------------------------------------- #
# attention (chunked, the plain versions of the kernels)                      #
# --------------------------------------------------------------------------- #
def _pick_chunk(T: int, target: int = 1024) -> int:
    c = min(T, target)
    while T % c:
        c //= 2
    return max(c, 1)


def chunked_attention(q, k, v, *, causal: bool = True, window: int = 0,
                      q_offset: int = 0, scale: Optional[float] = None,
                      chunk: int = 1024):
    """Chunked multi-head attention with GQA.

    q: (B, Tq, H, hd); k, v: (B, Tk, Hkv, hd_k/hd_v).  Each query chunk
    attends to the full key range (or the sliding window), with an fp32
    softmax; the probabilities are cast to v's dtype before the PV product,
    as in the reference.  Returns (B, Tq, H, hdv) in q's dtype.
    """
    B, Tq, H, hd = q.shape
    Tk, Hkv = k.shape[1], k.shape[2]
    hdv = v.shape[-1]
    G = H // Hkv
    scale = scale if scale is not None else 1.0 / math.sqrt(hd)
    c = _pick_chunk(Tq, chunk)
    nq = Tq // c
    use_window = 0 < window < Tk
    kv_span = min(Tk, window + c) if use_window else Tk
    kf = k.float()
    vf = v.float()
    out = torch.empty((B, Tq, H, hdv), dtype=q.dtype, device=q.device)
    for ci in range(nq):
        q_blk = q[:, ci * c:(ci + 1) * c].float().reshape(B, c, Hkv, G, hd)
        row = q_offset + ci * c + torch.arange(c, device=q.device)
        if use_window:
            start = min(max(ci * c + q_offset - window + 1, 0), Tk - kv_span)
        else:
            start = 0
        k_blk = kf[:, start:start + kv_span]
        v_blk = vf[:, start:start + kv_span]
        col = start + torch.arange(kv_span, device=q.device)
        s = torch.einsum("bckgh,btkh->bckgt", q_blk, k_blk) * scale
        mask = torch.ones((c, kv_span), dtype=torch.bool, device=q.device)
        if causal:
            mask &= col[None, :] <= row[:, None]
        if window > 0:
            mask &= col[None, :] > row[:, None] - window
        s = torch.where(mask[None, :, None, None, :], s,
                        torch.full_like(s, _NEG_INF))
        p = torch.softmax(s, dim=-1).to(v.dtype).float()
        o = torch.einsum("bckgt,btkh->bckgh", p, v_blk)
        out[:, ci * c:(ci + 1) * c] = o.reshape(B, c, H, hdv).to(q.dtype)
    return out


def decode_attention(q, k_cache, v_cache, cur_len, *,
                     scale: Optional[float] = None):
    """Single-token attention against a (possibly ring-buffered) KV cache.

    q: (B, H, hd); k_cache/v_cache: (B, S, Hkv, hd), of q's dtype or not
    (an fp32 q against a bf16 cache is the default serving case); cur_len:
    an int, a 0-d tensor or (B,) int — tokens already in context (the new
    token's position, per request when (B,)).  Every slot
    < min(cur_len + 1, S) is valid (the new token was written first).
    """
    B, S, Hkv, hd = k_cache.shape
    H = q.shape[1]
    G = H // Hkv
    hdv = v_cache.shape[-1]
    scale = scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    qg = q.float().reshape(B, Hkv, G, -1)
    s = torch.einsum("bkgh,bskh->bkgs", qg, k_cache.float()) * scale
    cur = torch.as_tensor(cur_len, dtype=torch.int64, device=q.device)
    cur = cur.expand(B) if cur.dim() == 0 else cur
    valid = (torch.arange(S, device=q.device)[None, :]
             < torch.clamp(cur + 1, max=S)[:, None])
    s = torch.where(valid[:, None, None, :], s, torch.full_like(s, _NEG_INF))
    p = torch.softmax(s, dim=-1).to(v_cache.dtype).float()
    o = torch.einsum("bkgs,bskh->bkgh", p, v_cache.float())
    return o.reshape(B, H, hdv).to(q.dtype)
