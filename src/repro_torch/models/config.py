"""Model configuration (a trimmed copy of the JAX package's
``models/config.py``).

A single ``ModelConfig`` dataclass describes every family the reference
handles; the port serves the families whose blocks it has ported
(``repro_torch.models.blocks``).  ``layer_plan`` lists each layer's block
kind and MLP kind; ``layer_groups`` groups consecutive identical layers the
way the reference stacks its parameters, which is the layout
``repro_torch.models.convert`` reads.  Pure Python: no torch, no jax.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import List, Tuple

__all__ = ["ModelConfig", "BlockSpec", "layer_plan", "layer_groups", "reduce_config"]


# Block kinds: how a layer mixes across the sequence dimension.
ATTN = "attn"          # full (causal or bidirectional) softmax attention
LOCAL_ATTN = "local"   # sliding-window attention (sub-quadratic)
MLA = "mla"            # DeepSeek multi-head latent attention
RWKV6 = "rwkv6"        # Finch data-dependent-decay linear attention
RGLRU = "rglru"        # RecurrentGemma real-gated LRU recurrence

# MLP kinds.
DENSE = "dense"        # gated (SwiGLU) or plain (GELU) feed-forward
MOE = "moe"            # shared + routed top-k mixture of experts


@dataclass(frozen=True)
class BlockSpec:
    """One layer's static structure."""

    kind: str            # ATTN | LOCAL_ATTN | MLA | RWKV6 | RGLRU
    mlp: str             # DENSE | MOE
    cross_attn: bool = False   # decoder layer attends to encoder output


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                    # dense|moe|ssm|hybrid|audio|vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int

    head_dim: int = 0              # 0 -> d_model // n_heads
    qk_norm: bool = False
    mlp_act: str = "swiglu"        # swiglu | gelu
    tie_embeddings: bool = False
    rope_theta: float = 1e4
    norm_eps: float = 1e-6
    norm_kind: str = "rmsnorm"     # rmsnorm | layernorm

    # ---- attention pattern -------------------------------------------------
    window: int = 0                # sliding window size for LOCAL_ATTN
    attn_pattern: Tuple[str, ...] = ()   # repeating kinds; () -> all ATTN
    causal: bool = True

    # ---- MoE ---------------------------------------------------------------
    n_experts: int = 0
    n_experts_pad: int = 0         # dead experts appended so E shards evenly
    n_shared_experts: int = 0
    top_k: int = 0
    d_expert: int = 0              # routed-expert hidden size
    d_shared: int = 0              # total shared-expert hidden size
    first_dense: int = 0           # first k layers stay dense (DeepSeek)
    router_aux_coef: float = 0.01  # load-balance loss coefficient
    router_z_coef: float = 1e-4
    shared_gate: bool = False      # Qwen2-MoE sigmoid gate on shared experts
    capacity_factor: float = 1.25

    # ---- MLA (DeepSeek) ----------------------------------------------------
    mla: bool = False
    q_lora_rank: int = 0
    kv_lora_rank: int = 0
    qk_nope_head_dim: int = 0
    qk_rope_head_dim: int = 0
    v_head_dim: int = 0

    # ---- MTP (DeepSeek multi-token prediction) ------------------------------
    mtp: bool = False
    mtp_coef: float = 0.3

    # ---- RWKV6 / RG-LRU ----------------------------------------------------
    rwkv_head_dim: int = 64
    lru_width: int = 0             # 0 -> d_model

    # ---- encoder-decoder / frontend stubs ----------------------------------
    encoder_layers: int = 0        # >0 -> enc-dec (whisper)
    frontend: str = ""             # "audio" | "vision" | "" (stub embeddings)
    n_frontend_tokens: int = 0     # vision stub: # of patch embeddings

    def __post_init__(self):
        if self.head_dim == 0:
            object.__setattr__(self, "head_dim", self.d_model // self.n_heads)
        if self.lru_width == 0:
            object.__setattr__(self, "lru_width", self.d_model)
        if self.n_experts and self.d_expert == 0:
            object.__setattr__(self, "d_expert", self.d_ff)

    # ---- derived -----------------------------------------------------------
    @property
    def is_encdec(self) -> bool:
        return self.encoder_layers > 0

    @property
    def sub_quadratic(self) -> bool:
        """True when decode cost does not grow with context length (needed
        for the long_500k shape): every layer is recurrent or local."""
        kinds = {b.kind for b in layer_plan(self)}
        return kinds <= {LOCAL_ATTN, RWKV6, RGLRU}

    def param_count(self) -> int:
        """Analytical parameter count (backbone; frontends are stubs)."""
        D, F, V = self.d_model, self.d_ff, self.vocab
        hd = self.head_dim
        total = V * D                                  # embed
        if not self.tie_embeddings:
            total += D * V                             # lm head
        def attn_params() -> int:
            if self.mla:
                qr, kvr = self.q_lora_rank, self.kv_lora_rank
                nd, rd, vd = self.qk_nope_head_dim, self.qk_rope_head_dim, self.v_head_dim
                p = D * qr + qr * self.n_heads * (nd + rd)          # q loras
                p += D * (kvr + rd)                                  # kv down + k_rope
                p += kvr * self.n_heads * (nd + vd)                  # kv up
                p += self.n_heads * vd * D                           # out
                return p
            p = D * self.n_heads * hd + 2 * D * self.n_kv_heads * hd
            p += self.n_heads * hd * D
            return p
        def mlp_params(kind: str) -> int:
            if kind == MOE:
                e = self.n_experts * 3 * D * self.d_expert
                e += D * self.n_experts                              # router
                if self.d_shared:
                    e += 3 * D * self.d_shared
                return e
            mult = 3 if self.mlp_act == "swiglu" else 2
            return mult * D * F
        def seqmix_params(kind: str) -> int:
            if kind in (ATTN, LOCAL_ATTN):
                return attn_params()
            if kind == MLA:
                return attn_params()
            if kind == RWKV6:
                # r,k,v,g,o projections + decay/bonus + token-shift loras
                return 5 * D * D + 2 * D + 6 * D * 32 * 2
            if kind == RGLRU:
                W = self.lru_width
                # in/out proj x2 branches + gates
                return 2 * D * W + W * D + 2 * W * (W // max(1, self.n_heads))
            raise ValueError(kind)
        for blk in layer_plan(self):
            total += seqmix_params(blk.kind) + mlp_params(blk.mlp)
            if blk.cross_attn:
                total += attn_params()
        if self.encoder_layers:
            total += self.encoder_layers * (seqmix_params(ATTN) + mlp_params(DENSE))
        if self.mtp:
            total += seqmix_params(ATTN) + mlp_params(DENSE) + 2 * D * D
        return total

    def active_param_count(self) -> int:
        """Parameters touched per token (MoE: shared + top-k routed only)."""
        if not self.n_experts:
            return self.param_count()
        D = self.d_model
        inactive_per_moe = (self.n_experts - self.top_k) * 3 * D * self.d_expert
        n_moe = sum(1 for b in layer_plan(self) if b.mlp == MOE)
        return self.param_count() - n_moe * inactive_per_moe


def layer_plan(cfg: ModelConfig) -> List[BlockSpec]:
    """Per-layer block specs for the decoder stack (encoder handled apart)."""
    plan: List[BlockSpec] = []
    pattern = cfg.attn_pattern or (ATTN,)
    for i in range(cfg.n_layers):
        kind = pattern[i % len(pattern)]
        if cfg.mla:
            kind = MLA if kind == ATTN else kind
        mlp = DENSE
        if cfg.n_experts and i >= cfg.first_dense:
            mlp = MOE
        plan.append(BlockSpec(kind, mlp, cross_attn=cfg.is_encdec))
    return plan


def layer_groups(cfg: ModelConfig) -> List[Tuple[BlockSpec, int]]:
    """Group *consecutive identical* BlockSpecs → (spec, count), as the
    reference stacks its parameters (RecurrentGemma's rec,rec,attn pattern
    gives alternating groups of 2 and 1)."""
    plan = layer_plan(cfg)
    groups: List[Tuple[BlockSpec, int]] = []
    for blk in plan:
        if groups and groups[-1][0] == blk:
            groups = groups[:-1] + [(blk, groups[-1][1] + 1)]
        else:
            groups.append((blk, 1))
    return groups


def reduce_config(cfg: ModelConfig, *, layers: int = 0, d_model: int = 64,
                  vocab: int = 256) -> ModelConfig:
    """A tiny same-family config for CPU smoke tests."""
    pattern = cfg.attn_pattern or (ATTN,)
    n_layers = layers or max(2, len(pattern))
    n_heads = 4
    n_kv = min(cfg.n_kv_heads, n_heads) if cfg.n_kv_heads < cfg.n_heads else n_heads
    n_kv = max(1, min(n_kv, 2))
    changes = dict(
        n_layers=n_layers,
        d_model=d_model,
        n_heads=n_heads,
        n_kv_heads=n_kv,
        head_dim=d_model // n_heads,
        d_ff=d_model * 2,
        vocab=vocab,
        window=min(cfg.window, 16) if cfg.window else 0,
        lru_width=d_model,
        rwkv_head_dim=d_model // n_heads,
    )
    if cfg.n_experts:
        changes.update(
            n_experts=4, top_k=2, d_expert=d_model,
            d_shared=d_model if cfg.d_shared else 0,
            first_dense=min(cfg.first_dense, 1),
        )
    if cfg.mla:
        changes.update(
            q_lora_rank=d_model // 2, kv_lora_rank=d_model // 2,
            qk_nope_head_dim=d_model // n_heads,
            qk_rope_head_dim=(d_model // n_heads) // 2,
            v_head_dim=d_model // n_heads,
        )
    if cfg.encoder_layers:
        changes["encoder_layers"] = 2
    if cfg.n_frontend_tokens:
        changes["n_frontend_tokens"] = 8
    return dataclasses.replace(cfg, **changes)
