#!/usr/bin/env python3
"""A/B of the recurrences' two routes in the served models' prefill, on one
GPU.

    python3 ab_prefill.py            # from the root of a checkout

For each served architecture (RecurrentGemma-2B, RWKV6-7B: full depth,
random bf16 weights from the serve's seed), the serve's prompts
(``chip_smoke.py`` phase 7: 8 of 1,024-2,000 tokens) are prefilled one by
one into a one-slot bf16 cache, with both recurrences (the RG-LRU scan and
the WKV recurrence) forced onto one route: ``"sequential"`` (the kernels
as they were before the chunked route existed) or ``"chunked"``.  Routes
take turns in one process, sequential, chunked, chunked, sequential, twice,
after a warm-up of each: host walls vary too much between processes to
compare two of them.  Each prefill of all prompts is timed on the host
clock between two synchronisations (what a user waits for), and each turn
prints one JSON line; then a line per route with the mean, least and
largest seconds.  The card's name and power limit come first.

Imports nothing of JAX.  Exits non-zero without a CUDA device.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
ROUTES = ("sequential", "chunked")


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("ab_prefill: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    from repro_torch.configs import get_config
    from repro_torch.kernels import rglru_scan, rwkv6_scan
    from repro_torch.models import backbone

    torch.backends.cuda.matmul.allow_tf32 = False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip(), flush=True)
    for arch, spec in chip_smoke.SERVE_ARCHS.items():
        cfg = get_config(arch)
        gen = torch.Generator(device="cuda")
        gen.manual_seed(spec["seed"])
        params = backbone.init_params(cfg, gen, dtype=torch.bfloat16,
                                      device="cuda")
        rng = np.random.default_rng(spec["seed"])      # as phase 7 draws
        lens = rng.integers(1024, 2001, chip_smoke.SERVE_REQUESTS)
        prompts = [torch.as_tensor(rng.integers(1, cfg.vocab, size=int(n)),
                                   device="cuda")[None] for n in lens]
        caches = backbone.init_cache(cfg, 1, chip_smoke.SERVE_CACHE,
                                     dtype=torch.bfloat16, device="cuda")

        def prefill_s(route):
            rwkv6_scan.wkv6_route = lambda *shape: route
            rglru_scan.rglru_route = lambda *shape: route
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for p in prompts:
                backbone.prefill(cfg, params, {"tokens": p}, caches)
            torch.cuda.synchronize()
            return time.perf_counter() - t0

        for route in ROUTES:                            # warm-up
            prefill_s(route)
        runs = {route: [] for route in ROUTES}
        for rep in range(2):
            for route in ("sequential", "chunked", "chunked", "sequential"):
                s = prefill_s(route)
                runs[route].append(s)
                print(json.dumps({"arch": arch, "rep": rep, "route": route,
                                  "s": s, "tokens": int(lens.sum()),
                                  "tokens_per_s": float(lens.sum()) / s}),
                      flush=True)
        for route, v in runs.items():
            print(json.dumps({"arch": arch, "route": route,
                              "mean_s": sum(v) / len(v), "min_s": min(v),
                              "max_s": max(v), "tokens": int(lens.sum())}),
                  flush=True)
        del params, caches
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
