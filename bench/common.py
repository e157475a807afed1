"""Paths and loaders the harness shares: the checkout's root, the JSON
files of a cell, and modules loaded from a file by name (a metric's name
may hold a dot, so it is no module path)."""
from __future__ import annotations

import importlib.util
import json
import sys
from pathlib import Path
from types import ModuleType
from typing import Any, Dict

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent

#: top-level module names that may not be loaded in a run (the JAX
#: package and JAX itself), compared whole: ``repro_torch`` is allowed
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def load_json(path: Path) -> Dict[str, Any]:
    with open(path) as f:
        return json.load(f)


def benchmark() -> Dict[str, Any]:
    return load_json(ROOT / "BENCHMARK.json")


def cell(name: str) -> Dict[str, Any]:
    """The workload ``name`` with its configuration, traffic mix and
    limits read from their files: ``{"workload", "config", "traffic",
    "limits"}``."""
    bench = benchmark()
    by_name = {w["name"]: w for w in bench["workloads"]}
    if name not in by_name:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; known: "
                       f"{sorted(by_name)}")
    work = by_name[name]
    conf = {c["name"]: c for c in bench["configs"]}[work["config"]]
    return {"workload": work,
            "config": load_json(ROOT / conf["file"]),
            "traffic": load_json(BENCH / "traffic" / f"{work['traffic']}.json"),
            "limits": load_json(BENCH / "limits" / f"{name}.json")}


def load_module(path: Path) -> ModuleType:
    """The module in ``path``, loaded under a name of its own."""
    name = "bench_file_" + "_".join(path.relative_to(BENCH).with_suffix("")
                                    .parts).replace(".", "_").replace("-", "_")
    if name in sys.modules:
        return sys.modules[name]
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


def forbidden_loaded() -> list:
    """The loaded modules whose top-level name is forbidden."""
    return sorted({m for m in sys.modules
                   if m.split(".")[0] in FORBIDDEN})
