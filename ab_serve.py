#!/usr/bin/env python3
"""A/B of phase 7's Llama-3-8B serve (16 layers) between the parent's
tree and this one, on one GPU.

    git archive <parent> | tar -x -C .scratch/parent   # .scratch: ignored
    python3 ab_serve.py                                 # from the root

Runs ``chip_smoke.phase_serve`` for Llama-3-8B (random bf16 weights, 4
slots, 8 requests; after ``phase_device`` builds the kernels) from
``.scratch/parent`` and from this tree, in turns — parent, change, change,
parent — each in its own process from its tree's root, and prints a JSON
line a turn: ms a decode step, host operators a step, prefill tokens/s and
the traced replay's busy share.  The card's name and power limit come
first.  Imports nothing of JAX.
"""
import json
import os
import subprocess
import sys

RUN = r'''
import json, sys, time
sys.path.insert(0, "src"); sys.path.insert(0, ".")
import numpy as np, torch
import chip_smoke as c
from repro_torch.kernels import cuda_lib
c.phase_device(torch, cuda_lib)
out = c.phase_serve(torch, np, c.LLAMA)
'''


def main():
    root = os.getcwd()
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    for name, tree in (("parent", ".scratch/parent"), ("change", "."),
                       ("change", "."), ("parent", ".scratch/parent")):
        p = subprocess.run([sys.executable, "-c", RUN],
                           cwd=os.path.join(root, tree), capture_output=True,
                           text=True)
        serve = [json.loads(line) for line in p.stdout.splitlines()
                 if line.startswith('{"phase": "serve"')]
        s = serve[0] if serve else {}
        print(json.dumps({
            "tree": name, "rc": p.returncode,
            "ms_per_decode_step": s.get("ms_per_decode_step"),
            "host_ops_per_decode_step": s.get("host_ops_per_decode_step"),
            "prefill_tokens_per_s": s.get("prefill_tokens_per_s"),
            "busy": (s.get("traced_window") or {}).get("busy_share"),
            "err": p.stderr[-1500:] if p.returncode else ""}), flush=True)


if __name__ == "__main__":
    main()
