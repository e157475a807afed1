"""Work of one training step of a pre-norm transformer (decoder-only, or
encoder-decoder when ``encoder_layers`` is set), from its shapes.

``train_flops``: the model FLOPs a step needs, forward and backward, as
the MFU convention counts them and without remat's recompute: 6 FLOPs a
position for every matrix parameter the position passes through (the
encoder's frames through the encoder and the cross-attention's K / V
projections, the decoder's tokens through the decoder, the head over the
``T - 1`` positions whose next token is predicted), plus 3 times the
forward attention products.

``attention_calls``: the forward attention calls of one step, one entry
a kind of call with how many a step makes.  A call's FLOPs are 4 hd a
(query, key) pair that no mask removes (Q K^T and P V, 2 each), its bytes
Q, K and V read once and O written once, in fp32.
"""
from __future__ import annotations

from typing import Dict, List


def _pairs(Tq: int, Tk: int, causal: bool) -> int:
    return Tq * (Tq + 1) // 2 if causal else Tq * Tk


def _attn_params(m: Dict) -> int:
    D, H, Hkv, hd = m["d_model"], m["n_heads"], m["n_kv_heads"], m["head_dim"]
    return D * (H + 2 * Hkv) * hd + H * hd * D


def _mlp_params(m: Dict) -> int:
    return (3 if m["mlp_act"] == "swiglu" else 2) * m["d_model"] * m["d_ff"]


def attention_calls(m: Dict, t: Dict) -> List[Dict]:
    B, T = t["batch"], t["seq_len"]
    H, Hkv, hd = m["n_heads"], m["n_kv_heads"], m["head_dim"]
    calls = [dict(name="decoder self", B=B, Tq=T, Tk=T, H=H, Hkv=Hkv, hd=hd,
                  causal=True, count=m["n_layers"])]
    if m.get("encoder_layers"):
        S = t["enc_frames"]
        calls += [dict(name="encoder self", B=B, Tq=S, Tk=S, H=H, Hkv=Hkv,
                       hd=hd, causal=False, count=m["encoder_layers"]),
                  dict(name="cross", B=B, Tq=T, Tk=S, H=H, Hkv=Hkv, hd=hd,
                       causal=False, count=m["n_layers"])]
    for c in calls:
        c["flops"] = 4 * c["hd"] * c["B"] * c["H"] * _pairs(
            c["Tq"], c["Tk"], c["causal"])
        c["bytes"] = 4 * c["B"] * c["hd"] * (
            2 * c["Tq"] * c["H"] + 2 * c["Tk"] * c["Hkv"])
    return calls


def train_flops(m: Dict, t: Dict) -> int:
    B, T, D, V = t["batch"], t["seq_len"], m["d_model"], m["vocab"]
    dec = _attn_params(m) + _mlp_params(m)
    matmul = B * T * m["n_layers"] * dec + B * (T - 1) * D * V
    if m.get("encoder_layers"):
        S = t["enc_frames"]
        matmul += B * S * m["encoder_layers"] * (_attn_params(m)
                                                 + _mlp_params(m))
        # cross-attention: Q and O over the tokens, K and V over the frames
        q_o = 2 * D * m["n_heads"] * m["head_dim"]
        k_v = 2 * D * m["n_kv_heads"] * m["head_dim"]
        matmul += m["n_layers"] * (B * T * q_o + B * S * k_v)
    attn = sum(c["count"] * c["flops"] for c in attention_calls(m, t))
    return 6 * matmul + 3 * attn
