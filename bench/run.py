#!/usr/bin/env python3
"""Run one cell of the port's benchmark once, from the root of a checkout:

    python3 bench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1> [--chrome-trace PATH]

The cell (``BENCHMARK.json``'s ``workloads``) names its configuration and
traffic mix; the mix's ``kind`` names the runner (``drive_<kind>.py``).
The run makes its inputs and weights from ``--seed``, warms up, measures
for ``--seconds``, checks what the timed path produced against the plain
reference, and prints one JSON object as the last line of its standard
output: the end-to-end metrics with ``--trace 0``, the per-layer ones
with ``--trace 1``, and last the numbers compared beside their limits
(also the last lines of its standard error).  ``--chrome-trace`` writes
the traced window's full trace there (hundreds of MB).

It exits non-zero and prints no result where the machine has fewer CUDA
devices than the cell asks for (nothing falls back to the CPU), where the
program (``src/repro_torch``) is absent, or where a module of JAX or of
the JAX package was loaded.  Caches of kernels go under ``build/`` in the
checkout, at fixed paths.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
CACHES = {"TRITON_CACHE_DIR": "triton", "TORCH_EXTENSIONS_DIR": "torch_ext",
          "CUDA_CACHE_PATH": "cuda"}


def parse(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--chrome-trace", default="")
    return ap.parse_args(argv)


def power_limit() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "unknown"


def main(argv=None) -> int:
    args = parse(argv)
    sys.path.insert(0, str(ROOT))
    from bench import common

    c = common.cell(args.workload)
    for var, sub in CACHES.items():
        os.environ[var] = str(ROOT / "build" / "bench-cache" / sub)
    import torch

    chips = c["workload"]["chips"]
    found = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if found < chips:
        print(f"bench: {args.workload} needs {chips} CUDA device(s), this "
              f"machine has {found}; nothing measured (no CPU fallback)",
              file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch").is_dir():
        print(f"bench: the program is not in this checkout "
              f"({ROOT / 'src' / 'repro_torch'}); nothing measured",
              file=sys.stderr)
        return 3
    sys.path.insert(0, str(ROOT / "src"))
    import importlib

    runner = importlib.import_module(f"bench.drive_{c['traffic']['kind']}")
    result = runner.run(c, args.seed, args.seconds, bool(args.trace),
                        device="cuda", t_start=T_START,
                        chrome_trace=args.chrome_trace or None)
    bad = common.forbidden_loaded()
    if bad:
        print(f"bench: modules of JAX or of the JAX package were loaded: "
              f"{bad}; no result", file=sys.stderr)
        return 4
    info = result.pop("info")
    info["card"] = power_limit()
    print(json.dumps({"info": info}))
    for name, chk in result["checks"].items():
        print(f"check {name} {chk['value']!r} limit {chk['limit']!r}",
              file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
