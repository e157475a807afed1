"""Whisper-large-v3 backbone  [arXiv:2212.04356].

Encoder-decoder: 32 encoder + 32 decoder layers, d_model=1280 20H (MHA,
kv=20) d_ff=5120 vocab=51866, GELU MLP, LayerNorm; the encoder adds
sinusoidal positions (the reference's stand-in for learned ones).  The conv
audio frontend is a STUB: callers give precomputed frame embeddings
``enc_embeds`` (B, S, 1280), 1,500 frames for 30 s of audio.
"""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="whisper-large-v3",
    family="audio",
    n_layers=32,                # decoder layers
    encoder_layers=32,
    d_model=1280,
    n_heads=20,
    n_kv_heads=20,
    d_ff=5120,
    vocab=51866,
    head_dim=64,
    mlp_act="gelu",
    norm_kind="layernorm",
    frontend="audio",
)
