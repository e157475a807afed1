"""RWKV-6 "Finch" 7B  [arXiv:2404.05892].

32L d_model=4096 (attention-free, data-dependent decay), channel-mix
d_ff=14336, vocab=65536, head size 64 (=> 64 WKV heads).  Sub-quadratic:
decode state is O(heads x 64 x 64) per layer -> runs the long_500k shape.
"""
from ..models.config import ModelConfig, RWKV6

CONFIG = ModelConfig(
    name="rwkv6-7b",
    family="ssm",
    n_layers=32,
    d_model=4096,
    n_heads=64,                # d_model / rwkv_head_dim
    n_kv_heads=64,
    d_ff=14336,
    vocab=65536,
    head_dim=64,
    rwkv_head_dim=64,
    attn_pattern=(RWKV6,),
    mlp_act="swiglu",
)
