"""Plain PyTorch reference of a pre-norm transformer: a decoder-only LM
(SmolLM-360M) or an encoder-decoder (Whisper-large-v3 with its audio
frontend a stub: frame embeddings come in), in fp32, from the published
architectures, with the conventions the configuration file lists under
``assumed``:

* norms scale by ``1 + w`` (w starts at 0) and have no bias; RMSNorm or
  LayerNorm by ``norm_kind``;
* self-attention has rotary position embeddings (halves split, angles
  ``pos * theta ** (-2i / hd)``, the power taken in fp64), grouped-query
  heads (query head h reads KV head ``h // (H / Hkv)``), no biases;
  cross-attention has none of them and sees every frame;
* the encoder adds sinusoids of the same angles at ``theta = 1e4`` over
  ``d_model`` (sines, then cosines) to its frames;
* the MLP is SwiGLU, or a GELU (tanh form) MLP with biases;
* the loss is the mean next-token cross-entropy over ``B (T - 1)``
  positions, logits from the tied embedding or the head.

Attention is the plain product of the whole score matrix, and every
layer is recomputed in the backward (``torch.utils.checkpoint``), so
that a full-size step fits beside nothing else.  No kernel, cache or
batching.
"""
from __future__ import annotations

import math
from typing import Dict, List

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint


def _attn_leaves(m: Dict, cross: bool = False):
    D, H, Hkv, hd = m["d_model"], m["n_heads"], m["n_kv_heads"], m["head_dim"]
    out = [("ln", (D,), 0.0),
           ("wq", (D, H, hd), 1 / math.sqrt(D)),
           ("wk", (D, Hkv, hd), 1 / math.sqrt(D)),
           ("wv", (D, Hkv, hd), 1 / math.sqrt(D)),
           ("wo", (H, hd, D), 1 / math.sqrt(H * hd))]
    if m.get("qk_norm") and not cross:
        out += [("qn", (hd,), 0.0), ("kn", (hd,), 0.0)]
    return out


def _mlp_leaves(m: Dict):
    D, Fd = m["d_model"], m["d_ff"]
    if m["mlp_act"] == "swiglu":
        return [("ln", (D,), 0.0), ("wg", (D, Fd), 1 / math.sqrt(D)),
                ("wu", (D, Fd), 1 / math.sqrt(D)),
                ("wd", (Fd, D), 1 / math.sqrt(Fd))]
    return [("ln", (D,), 0.0), ("wi", (D, Fd), 1 / math.sqrt(D)),
            ("wo", (Fd, D), 1 / math.sqrt(Fd)), ("bi", (Fd,), 0.0),
            ("bo", (D,), 0.0)]


def _stacked(prefix, count, parts):
    return [(prefix + (part, name), (count,) + shape, scale)
            for part, leaves in parts for name, shape, scale in leaves]


def layout(m: Dict) -> List:
    """``(path, shape, scale)`` of every parameter, each layer kind's
    leaves stacked along a leading layer axis; ``scale`` bounds a uniform
    draw (embedding and head 0.02, a projection 1 / sqrt(fan-in)), 0 is a
    zero leaf."""
    D, V, L = m["d_model"], m["vocab"], m["n_layers"]
    dec = [("mix", _attn_leaves(m))]
    if m.get("encoder_layers"):
        dec.append(("cross", _attn_leaves(m, cross=True)))
    dec.append(("mlp", _mlp_leaves(m)))
    out = [(("embed",), (V, D), 0.02), (("final_norm",), (D,), 0.0)]
    if not m["tie_embeddings"]:
        out.append((("head",), (D, V), 0.02))
    out += _stacked(("groups", 0), L, dec)
    if m.get("encoder_layers"):
        out += _stacked(("enc", "groups", 0), m["encoder_layers"],
                        [("mix", _attn_leaves(m)), ("mlp", _mlp_leaves(m))])
        out.append((("enc", "final_norm"), (D,), 0.0))
    return out


# --------------------------------------------------------------------------- #
def norm(x, w, m: Dict):
    if m["norm_kind"] == "layernorm":
        x = x - x.mean(-1, keepdim=True)
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True)
                           + m["norm_eps"]) * (1 + w)


def angles(T: int, dim: int, theta: float, device):
    inv = (theta ** (torch.arange(0, dim, 2, dtype=torch.float64,
                                  device=device) / dim)).float().reciprocal()
    return torch.arange(T, dtype=torch.float32, device=device)[:, None] * inv


def rotate(x, theta: float):
    """x (B, T, H, hd): each head's halves rotated by its position."""
    a = angles(x.shape[1], x.shape[-1], theta, x.device)[:, None, :]
    c, s = torch.cos(a), torch.sin(a)
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([x1 * c - x2 * s, x1 * s + x2 * c], dim=-1)


def attention(q, k, v, causal: bool):
    """q (B, T, H, hd), k / v (B, S, Hkv, hd): softmax(q k^T / sqrt(hd)) v
    over the whole score matrix."""
    g = q.shape[2] // k.shape[2]
    k = k.repeat_interleave(g, dim=2)
    v = v.repeat_interleave(g, dim=2)
    s = torch.einsum("bthd,bshd->bhts", q, k) / math.sqrt(q.shape[-1])
    if causal:
        T, S = s.shape[-2:]
        s = s.masked_fill(torch.ones(T, S, dtype=torch.bool,
                                     device=s.device).triu(1), float("-inf"))
    return torch.einsum("bhts,bshd->bthd", s.softmax(-1), v)


def attn_block(m: Dict, p, x, kv=None, causal=True):
    """Pre-norm attention with its residual; ``kv`` (the encoder's
    output) makes it cross-attention."""
    h = norm(x, p["ln"], m)
    src = h if kv is None else kv
    q = torch.einsum("btd,dhe->bthe", h, p["wq"])
    k = torch.einsum("bsd,dhe->bshe", src, p["wk"])
    v = torch.einsum("bsd,dhe->bshe", src, p["wv"])
    if kv is None:
        if "qn" in p:
            q = norm(q, p["qn"], dict(m, norm_kind="rmsnorm"))
            k = norm(k, p["kn"], dict(m, norm_kind="rmsnorm"))
        q, k = rotate(q, m["rope_theta"]), rotate(k, m["rope_theta"])
    o = attention(q, k, v, causal and kv is None)
    return x + torch.einsum("bthe,hed->btd", o, p["wo"])


def mlp_block(m: Dict, p, x):
    h = norm(x, p["ln"], m)
    if m["mlp_act"] == "swiglu":
        return x + (F.silu(h @ p["wg"]) * (h @ p["wu"])) @ p["wd"]
    return x + F.gelu(h @ p["wi"] + p["bi"], approximate="tanh") @ p["wo"] \
        + p["bo"]


def _layer(m, p, x, enc, causal):
    x = attn_block(m, p["mix"], x, causal=causal)
    if "cross" in p:
        x = attn_block(m, p["cross"], x, kv=enc)
    return mlp_block(m, p["mlp"], x)


def _stack(m, group, count, x, enc, causal):
    for i in range(count):
        p = {part: {k: v[i] for k, v in leaves.items()}
             for part, leaves in group.items()}
        x = checkpoint(_layer, m, p, x, enc, causal, use_reentrant=False)
    return x


def loss(m: Dict, params, batch) -> torch.Tensor:
    tokens = batch["tokens"]
    enc = None
    if m.get("encoder_layers"):
        f = batch["enc_embeds"]
        a = angles(f.shape[1], m["d_model"], 1e4, f.device)
        f = f + torch.cat([torch.sin(a), torch.cos(a)], dim=-1)
        enc = _stack(m, params["enc"]["groups"][0], m["encoder_layers"], f,
                     None, causal=False)
        enc = norm(enc, params["enc"]["final_norm"], m)
    x = _stack(m, params["groups"][0], m["n_layers"],
               params["embed"][tokens], enc, causal=True)
    x = norm(x, params["final_norm"], m)[:, :-1]
    w = params["embed"].T if m["tie_embeddings"] else params["head"]
    logits = x @ w
    return F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                           tokens[:, 1:].reshape(-1))
