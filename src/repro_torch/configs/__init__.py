"""Architecture configs the port serves (one module per arch), and the
shape registry.

A trimmed copy of the JAX package's ``configs`` registry: only the
architectures whose blocks the port has ported are registered, in the
reference's order.  Every config mirrors the published architecture
exactly (its source is in its module's docstring).  ``get_config(name)``
returns the full config, ``get_reduced`` the small same-family config the
CPU tests use, and ``SHAPES`` the assigned input-shape set.  Unknown names,
and the reference's archs still to come, raise ``KeyError``.
"""
from __future__ import annotations

import importlib
from dataclasses import dataclass
from typing import Dict, List, Tuple

from ..models.config import ModelConfig, reduce_config

__all__ = ["ARCHS", "ALIASES", "ShapeSpec", "SHAPES", "get_config",
           "get_reduced", "shape_applicable", "all_cells"]

ARCHS: Tuple[str, ...] = (
    "qwen2_moe_a2_7b",
    "deepseek_v3_671b",
    "qwen3_8b",
    "granite_3_2b",
    "smollm_360m",
    "llama3_8b",
    "rwkv6_7b",
    "recurrentgemma_2b",
)

# canonical dashed ids (CLI) -> module names, with the reference's extra
# spellings (some name archs still to come, which get_config refuses)
ALIASES: Dict[str, str] = {a.replace("_", "-"): a for a in ARCHS}
ALIASES.update({
    "qwen2-moe-a2.7b": "qwen2_moe_a2_7b",
    "deepseek-v3-671b": "deepseek_v3_671b",
    "granite-3-2b": "granite_3_2b",
    "whisper-large-v3": "whisper_large_v3",
    "internvl2-76b": "internvl2_76b",
})


@dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str        # "train" | "prefill" | "decode"


SHAPES: Dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524288, 1, "decode"),
}


def get_config(name: str) -> ModelConfig:
    mod_name = ALIASES.get(name, name).replace("-", "_")
    if mod_name not in ARCHS:
        known = sorted(a for a, m in ALIASES.items() if m in ARCHS)
        raise KeyError(f"unknown arch {name!r} for the port; known: "
                       f"{known} (ROADMAP.md lists the rest)")
    mod = importlib.import_module(f".{mod_name}", __package__)
    return mod.CONFIG


def get_reduced(name: str) -> ModelConfig:
    return reduce_config(get_config(name))


def shape_applicable(cfg: ModelConfig, shape: ShapeSpec) -> Tuple[bool, str]:
    """Whether an (arch, shape) cell runs: the long_500k decode needs an
    arch whose decode cost does not grow with the context."""
    if shape.name == "long_500k" and not cfg.sub_quadratic:
        return False, "long_500k needs sub-quadratic attention (full-attn arch)"
    return True, ""


def all_cells() -> List[Tuple[str, str]]:
    """Every (arch, shape) cell of the port's archs, inapplicable ones
    included, in the reference's order."""
    return [(a, s) for a in ARCHS for s in SHAPES]
