"""InternVL2-Llama3-76B backbone  [arXiv:2404.16821].

Language backbone (Llama3-70B-like): 80L d_model=8192 64H (GQA kv=8)
d_ff=28672 vocab=128256.  The InternViT-6B vision frontend is a STUB:
callers give precomputed patch embeddings ``vision_embeds`` (B, 256, 8192),
which replace the embeddings of the first 256 tokens of the sequence (as
the reference's backbone does; its docstring says "prepended").
"""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-76b",
    family="vlm",
    n_layers=80,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=28672,
    vocab=128256,
    head_dim=128,
    rope_theta=5e5,
    mlp_act="swiglu",
    frontend="vision",
    n_frontend_tokens=256,
)
