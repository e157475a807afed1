"""The port stands alone: it imports neither jax nor the JAX package, and
its device entry points run on the card unless told otherwise."""
import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch import api
from repro_torch.core.alloc_torch import (TorchAllocBackend,
                                          TorchBatchedAllocator,
                                          resolve_device)
from repro_torch.sched.sweep import grid, run_batched

ROOT = pathlib.Path(__file__).resolve().parents[1]

_PROBE = r"""
import importlib, json, pkgutil, sys
import repro_torch
mods = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                               "repro_torch.")]
for m in mods:
    importlib.import_module(m)
import runpy
runpy.run_path(sys.argv[1], run_name="chip_smoke_probe")
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith(("jax.", "jaxlib"))
             or m == "repro" or m.startswith("repro."))
print(json.dumps({"modules": mods, "bad": bad}))
"""


def test_port_and_chip_smoke_import_no_jax_or_reference():
    src = ROOT / "src"
    proc = subprocess.run(
        [sys.executable, "-c", _PROBE, str(ROOT / "chip_smoke.py")],
        capture_output=True, text=True, timeout=120,
        env={**os.environ, "PYTHONPATH": str(src)})
    assert proc.returncode == 0, proc.stderr
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert "repro_torch.core.alloc_torch" in out["modules"]
    assert "repro_torch.kernels.ops" in out["modules"]
    assert out["bad"] == []


def _need_no_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works")


def test_allocators_default_to_cuda_and_raise_without_it():
    _need_no_cuda()
    for cls in (TorchBatchedAllocator, TorchAllocBackend):
        with pytest.raises(RuntimeError, match="CUDA"):
            cls()
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device("cuda")


def test_entry_points_default_to_cuda_and_raise_without_it():
    _need_no_cuda()
    w = api.WorkloadSpec("lublin", n_jobs=10, n_nodes=4, seed=0)
    with pytest.raises(RuntimeError, match="CUDA"):
        api.simulate(w, "GreedyP */OPT=MIN")
    with pytest.raises(RuntimeError, match="CUDA"):
        run_batched(grid([w], ["GreedyP */OPT=MIN"]))


def test_cpu_device_is_explicit():
    assert resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(ValueError):
        resolve_device("meta")
    r = api.simulate(api.WorkloadSpec("lublin", n_jobs=10, n_nodes=4, seed=0),
                     "GreedyP */OPT=MIN", device="cpu")
    assert np.isfinite(r.max_stretch) and r.max_stretch >= 1.0
