#!/usr/bin/env python3
"""A/B of the port's allocation path between checkouts, on one GPU.

    python3 ab_alloc.py OLD NEW NEW OLD       # checkout roots, run order

Each argument is the root of a checkout of this repository.  Each runs in
a process of its own, in the order given, on the same card, and prints one
JSON line: the card, then

* ``min_dispatch_ms`` — one OPT=MIN dispatch of 16 engine-like lanes
  (128 nodes, 32 columns, every column running, 9-13 freeze rounds a lane)
  through ``core.alloc_torch.maxmin_yields_batch``: milliseconds a call as
  the host issues it (CUDA events around eager calls, so host reads and
  launches count), and the yields' checksum, which must agree between
  checkouts;
* ``matvec_ms`` — ``ops.alloc_matvec`` at the same shape (device time,
  CUDA graph), beside ``bmm_ms`` of ``torch.bmm`` on the same inputs;
* then that checkout's ``chip_smoke.phase_slice`` (phase 4: 20 paper-size
  cells against host runs), which prints its own line.

Imports nothing of JAX.  Exits non-zero without a CUDA device or when a
run fails.
"""
from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

SHAPE = (16, 128, 32)


def run_tree(tree: Path) -> int:
    import numpy as np
    import torch

    sys.path[:0] = [str(tree / "src"), str(tree)]
    import chip_smoke as cs
    from repro_torch.core import alloc_torch
    from repro_torch.kernels import ops

    torch.backends.cuda.matmul.allow_tf32 = False
    B, N, W = SHAPE
    rng = np.random.default_rng(11)
    need = rng.choice([0.25, 0.5, 1.0], (B, 1, W))
    mult = rng.integers(1, 4, (B, N, W)) * (rng.random((B, N, W)) < 0.1)
    weight = need * mult
    args = [torch.from_numpy(a).cuda() for a in (
        weight > 0, weight, np.ones((B, W), dtype=bool))]
    y = alloc_torch.maxmin_yields_batch(*args).cpu().numpy()
    ones = torch.ones((B, W), dtype=torch.float64, device="cuda")
    line = {
        "tree": str(tree), "card": torch.cuda.get_device_name(0),
        "shape": list(SHAPE),
        "min_dispatch_ms": cs.eager_ms(
            torch, lambda: alloc_torch.maxmin_yields_batch(*args), 50),
        "yields_sum": float(y.sum()), "yields_max": float(y.max()),
        "matvec_ms": cs.device_ms(
            torch, lambda: ops.alloc_matvec(args[1], ones), 200),
        "bmm_ms": cs.device_ms(
            torch, lambda: torch.bmm(args[1], ones[:, :, None]), 200),
    }
    print(json.dumps(line), flush=True)
    cs.phase_slice(torch, np)
    return 0


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("ab_alloc: no CUDA device", file=sys.stderr)
        return 2
    if sys.argv[1:2] == ["--run"]:
        return run_tree(Path(sys.argv[2]).resolve())
    trees = sys.argv[1:]
    if not trees:
        print(__doc__, file=sys.stderr)
        return 2
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    rc = 0
    for tree in trees:
        proc = subprocess.run([sys.executable, __file__, "--run", tree])
        rc = rc or proc.returncode
    return rc


if __name__ == "__main__":
    sys.exit(main())
