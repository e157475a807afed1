"""DeepSeek-V3 671B  [arXiv:2412.19437; hf:deepseek-ai/DeepSeek-V3].

61L d_model=7168 128H, MLA (q_lora 1536, kv_lora 512, nope 128 + rope 64,
v 128), MoE: 1 shared + 256 routed top-8 with moe_intermediate=2048; first
3 layers dense (intermediate 18432); MTP (1 extra depth); vocab 129280.
"""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-v3-671b",
    family="moe",
    n_layers=61,
    d_model=7168,
    n_heads=128,
    n_kv_heads=128,             # MLA: per-head latent KV (spec kv=128)
    d_ff=18432,                 # dense (first_dense) layers' hidden size
    vocab=129280,
    rope_theta=1e4,
    head_dim=128,
    mla=True,
    q_lora_rank=1536,
    kv_lora_rank=512,
    qk_nope_head_dim=128,
    qk_rope_head_dim=64,
    v_head_dim=128,
    n_experts=256,
    top_k=8,
    d_expert=2048,
    n_shared_experts=1,
    d_shared=2048,
    first_dense=3,
    mtp=True,
    mlp_act="swiglu",
)
