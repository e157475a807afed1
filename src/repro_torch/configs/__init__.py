"""Architecture configs the port serves (one module per arch).

A trimmed copy of the JAX package's ``configs`` registry: only the
architectures whose blocks the port has ported are registered.
``get_config(name)`` returns the published config, ``get_reduced`` the
small same-family config the CPU tests use.  Unknown names raise.
"""
from __future__ import annotations

import importlib
from typing import Dict, Tuple

from ..models.config import ModelConfig, reduce_config

__all__ = ["ARCHS", "ALIASES", "get_config", "get_reduced"]

ARCHS: Tuple[str, ...] = (
    "recurrentgemma_2b",
    "rwkv6_7b",
)

# canonical dashed ids (CLI) -> module names
ALIASES: Dict[str, str] = {a.replace("_", "-"): a for a in ARCHS}


def get_config(name: str) -> ModelConfig:
    mod_name = ALIASES.get(name, name).replace("-", "_")
    if mod_name not in ARCHS:
        raise KeyError(f"unknown arch {name!r} for the port; known: "
                       f"{sorted(ALIASES)} (ROADMAP.md lists the rest)")
    mod = importlib.import_module(f".{mod_name}", __package__)
    return mod.CONFIG


def get_reduced(name: str) -> ModelConfig:
    return reduce_config(get_config(name))
