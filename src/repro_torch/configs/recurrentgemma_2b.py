"""RecurrentGemma-2B (Griffin)  [arXiv:2402.19427].

26L d_model=2560, pattern (RG-LRU, RG-LRU, local-attn) repeating (1 attn per
2 recurrent), 10H MQA (kv=1), local window 2048, d_ff=7680 (gated GeLU),
lru_width=2560, vocab=256000.
"""
from ..models.config import LOCAL_ATTN, RGLRU, ModelConfig

CONFIG = ModelConfig(
    name="recurrentgemma-2b",
    family="hybrid",
    n_layers=26,
    d_model=2560,
    n_heads=10,
    n_kv_heads=1,
    d_ff=7680,
    vocab=256000,
    head_dim=256,
    window=2048,
    attn_pattern=(RGLRU, RGLRU, LOCAL_ATTN),
    lru_width=2560,
    mlp_act="gelu_gated",
)
