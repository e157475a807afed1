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

``<kind>_axes(cfg)`` — the mirror of ``<kind>_init``'s dict: a tuple of
logical axis names a leaf (``launch.shardings`` maps them onto a mesh),
the reference's second return value of its init.

Ported: softmax attention (full and sliding-window, with the bf16/fp32
and the int8 KV-cache layouts), Whisper's cross-attention, DeepSeek's
multi-head latent attention (MLA), RWKV6 (time mix and channel mix), the
RG-LRU recurrent block and the dense MLP block (the MoE MLP is
``models/moe.py``).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ..kernels import ops as kops
from .config import ModelConfig
from .layers import mlp_apply, mlp_axes, mlp_init, norm, rope, uinit

__all__ = [
    "attn_init", "attn_axes", "attn_cache", "attn_apply",
    "cross_cache", "cross_apply",
    "mla_init", "mla_axes", "mla_cache", "mla_apply",
    "rwkv6_init", "rwkv6_axes", "rwkv6_cache", "rwkv6_apply",
    "rglru_init", "rglru_axes", "rglru_cache", "rglru_apply",
    "mlp_block_init", "mlp_block_axes", "mlp_block_apply",
]


def _zeros(shape, dtype, device):
    return torch.zeros(shape, dtype=dtype, device=device)


# =========================================================================== #
# softmax attention (full + local window)                                      #
# =========================================================================== #
def attn_init(cfg: ModelConfig, gen, dtype, device, cross: bool = False):
    """One attention layer's weights; ``cross`` (Whisper's decoder
    cross-attention) has no ``qk_norm`` weights, as in the reference."""
    D, H, Hkv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    p = {
        "ln": _zeros((D,), dtype, device),
        "wq": uinit(gen, (D, H, hd), 1 / math.sqrt(D), dtype, device),
        "wk": uinit(gen, (D, Hkv, hd), 1 / math.sqrt(D), dtype, device),
        "wv": uinit(gen, (D, Hkv, hd), 1 / math.sqrt(D), dtype, device),
        "wo": uinit(gen, (H, hd, D), 1 / math.sqrt(H * hd), dtype, device),
    }
    if cfg.qk_norm and not cross:
        p["qn"] = _zeros((hd,), dtype, device)
        p["kn"] = _zeros((hd,), dtype, device)
    return p


def attn_axes(cfg: ModelConfig, cross: bool = False):
    a = {"ln": ("d_model",),
         "wq": ("d_model", "heads", "head_dim"),
         "wk": ("d_model", "kv_heads", "head_dim"),
         "wv": ("d_model", "kv_heads", "head_dim"),
         "wo": ("heads", "head_dim", "d_model")}
    if cfg.qk_norm and not cross:
        a["qn"] = a["kn"] = ("head_dim",)
    return a


def attn_cache(cfg: ModelConfig, B: int, S: int, dtype, device):
    """KV cache.  dtype int8 selects the quantized layout: int8 ``k`` and
    ``v`` with fp32 scales ``ks`` and ``vs``, one a token and KV head
    (:func:`_kv_quant`), which halves the bytes a decode step reads from
    the cache."""
    shape = (B, S, cfg.n_kv_heads, cfg.head_dim)
    cache = {"k": _zeros(shape, dtype, device),
             "v": _zeros(shape, dtype, device)}
    if dtype == torch.int8:
        cache["ks"] = _zeros(shape[:3], torch.float32, device)
        cache["vs"] = _zeros(shape[:3], torch.float32, device)
    return cache


def _decode_pos(pos, B: int, device):
    """A decode step's position as an int64 tensor: a Python int stays 0-d
    (one slot written for every row); a tensor, 0-d or (B,), becomes (B,)
    per-request positions, so that no host reads it (the dry run's
    position lives on ``meta``)."""
    pos_t = torch.as_tensor(pos, dtype=torch.int64, device=device)
    if isinstance(pos, torch.Tensor) and pos_t.dim() == 0:
        pos_t = pos_t.expand(B)
    return pos_t


def _kv_quant(x):
    """x: (B, T, H, hd) -> (int8 values, (B, T, H) fp32 scales): a
    symmetric scale a token and head, ``amax / 127`` clamped at 1e-12, then
    round (half to even), clip to +-127 and cast."""
    xf = x.float()
    scale = torch.clamp(xf.abs().amax(dim=-1) / 127.0, min=1e-12)
    q = torch.clamp(torch.round(xf / scale[..., None]), -127, 127)
    return q.to(torch.int8), scale


def _kv_dequant(q, scale, dtype=torch.bfloat16):
    return (q.float() * scale[..., None]).to(dtype)


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
        pos_t = _decode_pos(pos, B, x.device)
        batched = pos_t.dim() == 1         # per-request positions (serving)
        positions = pos_t[:, None] if batched else pos_t.reshape(1)
        q, k, v = _qkv(cfg, p, h, positions)
        quant = "ks" in cache              # int8 KV layout
        S = cache["k"].shape[1]
        # the ring slot (window > 0) or the last slot: as the reference
        slot = pos_t % S if window > 0 else torch.clamp(pos_t, max=S - 1)
        if quant:
            (kq, ks1), (vq, vs1) = _kv_quant(k), _kv_quant(v)
            writes = (("k", kq), ("ks", ks1), ("v", vq), ("vs", vs1))
        else:
            writes = (("k", k), ("v", v))
        for name, val in writes:
            buf = cache[name]
            val = val[:, 0].to(buf.dtype)
            if batched:
                buf[torch.arange(B, device=x.device), slot] = val
            else:
                buf[:, int(slot)] = val
        if quant:       # the whole cache, dequantized for the kernel
            k_c = _kv_dequant(cache["k"], cache["ks"], h.dtype)
            v_c = _kv_dequant(cache["v"], cache["vs"], h.dtype)
        else:
            k_c, v_c = cache["k"], cache["v"]
        o = kops.flash_decode(q[:, 0], k_c, v_c, pos_t)
        y = (o.reshape(B, -1) @ wo)[:, None]
        return x + y, cache

    positions = pos + torch.arange(T, device=x.device)
    q, k, v = _qkv(cfg, p, h, positions)
    o = kops.flash_attention(q, k, v, causal=causal, window=window,
                             q_offset=0)
    y = o.reshape(B, T, -1) @ wo
    if mode == "prefill" and cache is not None:
        S = cache["k"].shape[1]
        pairs = [("k", k), ("v", v)]
        if "ks" in cache:                  # int8 KV layout
            (kq, ks1), (vq, vs1) = _kv_quant(k), _kv_quant(v)
            pairs = [("k", kq), ("v", vq), ("ks", ks1), ("vs", vs1)]
        for name, val in pairs:
            buf = cache[name]
            if T >= S:      # keep the last S tokens (ring window fully filled)
                buf.copy_(val[:, T - S:])
            else:
                buf[:, :T] = val
    return x + y, cache


# --------------------------------------------------------------------------- #
# cross-attention (Whisper's decoder): K/V come from the encoder output,      #
# cached once at prefill.                                                      #
# --------------------------------------------------------------------------- #
def cross_cache(cfg: ModelConfig, B: int, S_enc: int, dtype, device):
    """The cross K/V of ``S_enc`` encoder frames, of ``n_kv_heads`` heads:
    what prefill writes.  (The reference allocates ``n_heads`` and its
    prefill replaces the cache by the projections' ``n_kv_heads``; the two
    are equal for Whisper, 20 and 20, not for the reduced config, 4 over
    2.)"""
    shape = (B, S_enc, cfg.n_kv_heads, cfg.head_dim)
    return {"ck": _zeros(shape, dtype, device),
            "cv": _zeros(shape, dtype, device)}


def cross_apply(cfg: ModelConfig, p, x, mode: str, cache, enc_out):
    """``p``: attention weights without ``qk_norm``; ``enc_out`` (B, S_enc,
    D) in train and prefill, None in decode (which reads the cache).  No
    RoPE on either side.  Prefill attends over every frame (non-causal
    prompt attention) and writes the frames' K/V into the cache when it
    holds ``S_enc`` of them; a cache of 0 frames keeps nothing, as the
    reference's server, which sets its slot back into an empty cross cache
    (any other length raises, as the reference's does).  Decode attends
    over every cached frame (``cur_len = S_enc``)."""
    h = norm(x, p["ln"], cfg.norm_kind, cfg.norm_eps)
    B, T, D = h.shape
    q = (h @ p["wq"].reshape(D, -1)).reshape(B, T, cfg.n_heads, -1)
    wo = p["wo"].reshape(-1, D)
    if mode == "decode":
        ck, cv = cache["ck"], cache["cv"]
        o = kops.flash_decode(q[:, 0], ck, cv, ck.shape[1])
        return x + (o.reshape(B, -1) @ wo)[:, None], cache
    S = enc_out.shape[1]
    ck = (enc_out @ p["wk"].reshape(D, -1)).reshape(B, S, p["wk"].shape[1],
                                                    -1)
    cv = (enc_out @ p["wv"].reshape(D, -1)).reshape(B, S, p["wv"].shape[1],
                                                    -1)
    o = kops.flash_attention(q, ck, cv, causal=False)
    y = o.reshape(B, T, -1) @ wo
    if mode == "prefill" and cache is not None:
        S_cache = cache["ck"].shape[1]
        if S_cache == S:
            cache["ck"].copy_(ck)
            cache["cv"].copy_(cv)
        elif S_cache:
            raise ValueError(f"a cross cache of {S_cache} frames cannot take "
                             f"the K/V of {S} encoder frames")
    return x + y, cache


# =========================================================================== #
# MLA — DeepSeek multi-head latent attention                                   #
# =========================================================================== #
def mla_init(cfg: ModelConfig, gen, dtype, device):
    D, H = cfg.d_model, cfg.n_heads
    qr, kvr = cfg.q_lora_rank, cfg.kv_lora_rank
    nd, rd, vd = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim

    def u(shape, scale=None):
        return uinit(gen, shape, scale, dtype, device)
    return {
        "ln": _zeros((D,), dtype, device),
        "wdq": u((D, qr)),
        "qn": _zeros((qr,), dtype, device),
        "wuq": u((qr, H, nd + rd)),
        "wdkv": u((D, kvr + rd)),
        "kvn": _zeros((kvr,), dtype, device),
        "wuk": u((kvr, H, nd)),
        "wuv": u((kvr, H, vd)),
        "wo": u((H, vd, D), 1 / math.sqrt(H * vd)),
    }


def mla_axes(cfg: ModelConfig):
    return {"ln": ("d_model",), "wdq": ("d_model", "q_lora"),
            "qn": ("q_lora",), "wuq": ("q_lora", "heads", "head_dim"),
            "wdkv": ("d_model", "kv_lora"), "kvn": ("kv_lora",),
            "wuk": ("kv_lora", "heads", "head_dim"),
            "wuv": ("kv_lora", "heads", "head_dim"),
            "wo": ("heads", "head_dim", "d_model")}


def mla_cache(cfg: ModelConfig, B: int, S: int, dtype, device):
    """The latent cache: the normed KV latent ``ckv`` (B, S, kv_lora_rank)
    and the shared rotary key ``kr`` (B, S, qk_rope_head_dim)."""
    return {"ckv": _zeros((B, S, cfg.kv_lora_rank), dtype, device),
            "kr": _zeros((B, S, cfg.qk_rope_head_dim), dtype, device)}


def _mla_qkv_latent(cfg: ModelConfig, p, h, positions):
    nd, kvr = cfg.qk_nope_head_dim, cfg.kv_lora_rank
    B, T, _ = h.shape
    cq = norm(h @ p["wdq"], p["qn"], "rmsnorm", cfg.norm_eps)
    q = (cq @ p["wuq"].reshape(cq.shape[-1], -1)).reshape(
        B, T, cfg.n_heads, -1)                               # (B,T,H,nd+rd)
    q_nope, q_rope = q[..., :nd], rope(q[..., nd:], positions, cfg.rope_theta)
    dkv = h @ p["wdkv"]                                      # (B,T,kvr+rd)
    ckv = norm(dkv[..., :kvr], p["kvn"], "rmsnorm", cfg.norm_eps)
    k_rope = rope(dkv[..., kvr:], positions, cfg.rope_theta, heads=False)
    return q_nope, q_rope, ckv, k_rope


def _einsum(eq, a, b):
    """``torch.einsum`` of operands promoted to one type, as jnp.einsum
    promotes (a bf16 cache against fp32 weights gives fp32)."""
    dt = torch.promote_types(a.dtype, b.dtype)
    return torch.einsum(eq, a.to(dt), b.to(dt))


def mla_apply(cfg: ModelConfig, p, x, mode: str, cache, pos):
    """Prefill and train up-project the latent to per-head keys and values
    and call the attention kernel (qk head dim nd + rd, v head dim vd);
    decode works in latent space (the absorbed form) against the latent
    cache, with no kernel, as the reference."""
    nd, rd, vd = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim
    scale = 1.0 / math.sqrt(nd + rd)
    h = norm(x, p["ln"], cfg.norm_kind, cfg.norm_eps)
    B, T, D = h.shape
    H, kvr = cfg.n_heads, cfg.kv_lora_rank
    wo = p["wo"].reshape(-1, D)

    if mode == "decode":
        pos_t = _decode_pos(pos, B, x.device)
        batched = pos_t.dim() == 1         # per-request positions (serving)
        positions = pos_t[:, None] if batched else pos_t.reshape(1)
        q_nope, q_rope, ckv, k_rope = _mla_qkv_latent(cfg, p, h, positions)
        S = cache["ckv"].shape[1]
        slot = torch.clamp(pos_t, max=S - 1)
        for name, val in (("ckv", ckv), ("kr", k_rope)):
            buf = cache[name]
            val = val[:, 0].to(buf.dtype)
            if batched:
                buf[torch.arange(B, device=x.device), slot] = val
            else:
                buf[:, int(slot)] = val
        ckv_c, kr_c = cache["ckv"], cache["kr"]
        # absorbed decode: scores in latent space, from fp32 operands (the
        # reference's preferred_element_type=float32)
        q_lat = torch.einsum("bhk,rhk->bhr", q_nope[:, 0], p["wuk"])
        s = torch.einsum("bhr,bsr->bhs", q_lat.float(), ckv_c.float())
        s = s + torch.einsum("bhk,bsk->bhs", q_rope[:, 0].float(),
                             kr_c.float())
        cur = pos_t.expand(B) if not batched else pos_t
        valid = (torch.arange(S, device=x.device)[None, :]
                 < torch.clamp(cur + 1, max=S)[:, None])
        s = torch.where(valid[:, None, :], s * scale,
                        torch.full_like(s, -1e30))
        w = torch.softmax(s, dim=-1)
        o_lat = torch.einsum("bhs,bsr->bhr", w.to(ckv_c.dtype), ckv_c)
        o = _einsum("bhr,rhv->bhv", o_lat, p["wuv"])          # (B,H,vd)
        y = _einsum("bk,kd->bd", o.reshape(B, -1), wo)[:, None]
        return x + y, cache

    positions = pos + torch.arange(T, device=x.device)
    q_nope, q_rope, ckv, k_rope = _mla_qkv_latent(cfg, p, h, positions)
    k_nope = (ckv @ p["wuk"].reshape(kvr, -1)).reshape(B, T, H, nd)
    v = (ckv @ p["wuv"].reshape(kvr, -1)).reshape(B, T, H, vd)
    q = torch.cat([q_nope, q_rope], dim=-1)
    k = torch.cat([k_nope, k_rope[:, :, None, :].expand(B, T, H, rd)], dim=-1)
    o = kops.flash_attention(q, k, v, causal=True, scale=scale)
    y = o.reshape(B, T, -1) @ wo
    if mode == "prefill" and cache is not None:
        cache["ckv"][:, :T] = ckv
        cache["kr"][:, :T] = k_rope
    return x + y, cache


# =========================================================================== #
# RWKV6 (Finch) — time-mix + channel-mix                                       #
# =========================================================================== #
_LORA_R = 32
_DECAY_R = 64


def rwkv6_init(cfg: ModelConfig, gen, dtype, device):
    D, F_, H, dk = cfg.d_model, cfg.d_ff, cfg.n_heads, cfg.rwkv_head_dim

    def u(shape, scale=None):
        return uinit(gen, shape, scale, dtype, device)
    return {
        "ln_t": _zeros((D,), dtype, device),
        "mu_x": _zeros((D,), dtype, device),          # ddlerp base mix
        "mu": _zeros((5, D), dtype, device),          # per-target (w,k,v,r,g)
        "lora_a": u((D, 5 * _LORA_R)),
        "lora_b": u((5, _LORA_R, D), 0.01),
        "w0": torch.full((D,), -3.0, dtype=dtype, device=device),
        "wa": u((D, _DECAY_R)),
        "wb": u((_DECAY_R, D), 0.01),
        "u": u((H, dk), 0.5),                         # bonus
        "wr": u((D, D)), "wk": u((D, D)), "wv": u((D, D)), "wg": u((D, D)),
        "wo": u((D, D)),
        "gn": _zeros((H, dk), dtype, device),         # per-head groupnorm
        # channel mix
        "ln_c": _zeros((D,), dtype, device),
        "cmu_k": _zeros((D,), dtype, device),
        "cmu_r": _zeros((D,), dtype, device),
        "cwk": u((D, F_)), "cwv": u((F_, D)), "cwr": u((D, D)),
    }


def rwkv6_axes(cfg: ModelConfig):
    """``rwkv_d2`` (the time mix's inner width) has no sharding rule, so
    those matrices stay whole on ``model``, as in the reference."""
    d, d2 = ("d_model",), ("d_model", "rwkv_d2")
    return {"ln_t": d, "mu_x": d, "mu": (None, "d_model"),
            "lora_a": ("d_model", None), "lora_b": (None, None, "d_model"),
            "w0": d, "wa": ("d_model", None), "wb": (None, "d_model"),
            "u": ("heads", None), "wr": d2, "wk": d2, "wv": d2, "wg": d2,
            "wo": ("rwkv_d2", "d_model"), "gn": ("heads", None),
            "ln_c": d, "cmu_k": d, "cmu_r": d,
            "cwk": ("d_model", "d_ff"), "cwv": ("d_ff", "d_model"),
            "cwr": d2}


def rwkv6_cache(cfg: ModelConfig, B: int, S: int, dtype, device):
    """The token-shift inputs in the cache dtype and the WKV state in fp32,
    as the reference; S is unused (the state does not grow)."""
    H, dk = cfg.n_heads, cfg.rwkv_head_dim
    return {"x_tm": _zeros((B, cfg.d_model), dtype, device),
            "x_cm": _zeros((B, cfg.d_model), dtype, device),
            "s": _zeros((B, H, dk, dk), torch.float32, device)}


def _token_shift(x, x_prev):
    """x: (B, T, D); x_prev: (B, D), the last token of the previous
    segment."""
    return torch.cat([x_prev[:, None], x[:, :-1]], dim=1)


def _headify(x, H, d):
    B, T = x.shape[:2]
    return x.reshape(B, T, H, d)


def rwkv6_apply(cfg: ModelConfig, p, x, mode: str, cache, pos):
    B, T, D = x.shape
    H, dk = cfg.n_heads, cfg.rwkv_head_dim
    dtype = x.dtype
    if cache is not None:
        x_tm_prev = cache["x_tm"].to(dtype)
        x_cm_prev = cache["x_cm"].to(dtype)
        s0 = cache["s"]
    else:
        x_tm_prev = x_cm_prev = _zeros((B, D), dtype, x.device)
        s0 = _zeros((B, H, dk, dk), torch.float32, x.device)
    writes = cache is not None and mode in ("prefill", "decode")

    # ---- time mix ----------------------------------------------------------
    h = norm(x, p["ln_t"], cfg.norm_kind, cfg.norm_eps)
    dx = _token_shift(h, x_tm_prev) - h
    xxx = h + dx * p["mu_x"]
    mix = torch.tanh(xxx @ p["lora_a"]).reshape(B, T, 5, _LORA_R)
    mix = torch.einsum("btfr,frd->btfd", mix, p["lora_b"])
    tgt = h[:, :, None] + dx[:, :, None] * (p["mu"][None, None] + mix)
    x_w, x_k, x_v, x_r, x_g = tgt.unbind(2)                  # (B, T, D) each
    w_log = p["w0"] + torch.tanh(x_w @ p["wa"]) @ p["wb"]
    w = torch.exp(-torch.exp(w_log.float()))                  # decay in (0,1)
    r = _headify(x_r @ p["wr"], H, dk)
    k = _headify(x_k @ p["wk"], H, dk)
    v = _headify(x_v @ p["wv"], H, dk)
    g = F.silu(x_g @ p["wg"])
    w = _headify(w, H, dk)

    # the kernel writes sT straight into the cache's state (a slot view)
    y, _ = kops.wkv6(r, k, v, w, p["u"], s0,
                     state_out=cache["s"] if writes else None)
    # per-head group norm (population variance, as jnp.var)
    mu_ = y.mean(-1, keepdim=True)
    var = y.var(-1, keepdim=True, correction=0)
    yn = (y - mu_) * torch.rsqrt(var + 64e-5) * (1.0 + p["gn"])[None, None]
    x = x + (yn.reshape(B, T, D).to(dtype) * g) @ p["wo"]

    # ---- channel mix --------------------------------------------------------
    hc = norm(x, p["ln_c"], cfg.norm_kind, cfg.norm_eps)
    dxc = _token_shift(hc, x_cm_prev) - hc
    xk = hc + dxc * p["cmu_k"]
    xr = hc + dxc * p["cmu_r"]
    kk = torch.square(F.relu(xk @ p["cwk"]))
    x = x + torch.sigmoid(xr @ p["cwr"]) * (kk @ p["cwv"])

    if writes:
        cache["x_tm"].copy_(h[:, -1])
        cache["x_cm"].copy_(hc[:, -1])
    return x, cache


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


def rglru_axes(cfg: ModelConfig):
    return {"ln": ("d_model",), "w_x": ("d_model", "lru"),
            "w_g": ("d_model", "lru"), "conv_w": (None, "lru"),
            "conv_b": ("lru",), "rg_a": ("heads", None, None),
            "rg_x": ("heads", None, None), "rg_a_b": ("lru",),
            "rg_x_b": ("lru",), "lam": ("lru",), "w_out": ("lru", "d_model")}


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


def mlp_block_axes(cfg: ModelConfig):
    return {"ln": ("d_model",), **mlp_axes(cfg.mlp_act)}


def mlp_block_apply(cfg: ModelConfig, p, x):
    h = norm(x, p["ln"], cfg.norm_kind, cfg.norm_eps)
    return x + mlp_apply(p, h, cfg.mlp_act)

