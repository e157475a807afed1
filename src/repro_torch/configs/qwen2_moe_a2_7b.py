"""Qwen1.5-MoE-A2.7B  [hf:Qwen/Qwen1.5-MoE-A2.7B].

24L d_model=2048 16H (kv=16, i.e. MHA) moe_intermediate=1408 vocab=151936;
60 routed experts top-4 + 4 shared experts (shared intermediate 4x1408=5632)
with a sigmoid shared-expert gate.  All layers are MoE (first_dense=0).
"""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-moe-a2.7b",
    family="moe",
    n_layers=24,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=1408,                  # routed-expert hidden size
    vocab=151936,
    head_dim=128,
    rope_theta=1e6,
    n_experts=60,
    top_k=4,
    d_expert=1408,
    n_shared_experts=4,
    d_shared=5632,              # 4 x 1408
    shared_gate=True,
    mlp_act="swiglu",
)
