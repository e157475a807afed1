"""Serving launcher: batched continuous-batching decode.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch recurrentgemma-2b \
        --requests 8 --slots 4 --cache-len 4096 --max-new 96
    PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3-8b \
        --requests 8 --slots 4 --cache-len 4096 --max-new 64
    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-moe-a2.7b \
        --requests 8 --slots 4 --cache-len 4096 --max-new 64

Runs on the card unless ``--device cpu``; parameters are random, drawn
from ``--seed``.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from ..configs import get_config, get_reduced
from ..device import resolve_device
from ..models import backbone
from ..train.serve import BatchedServer, Request, ServeConfig

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--cache-len", type=int, default=256)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--dtype", choices=sorted(_DTYPES), default=None,
                    help="parameter dtype (default: bfloat16 on the card, "
                         "float32 on the CPU)")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    dtype = _DTYPES[args.dtype or ("bfloat16" if device.type == "cuda"
                                   else "float32")]
    cfg = get_reduced(args.arch) if args.reduced else get_config(args.arch)
    gen = torch.Generator(device=device)
    gen.manual_seed(args.seed)
    params = backbone.init_params(cfg, gen, dtype=dtype, device=device)
    srv = BatchedServer(cfg, params, ServeConfig(
        slots=args.slots, cache_len=args.cache_len,
        temperature=args.temperature, seed=args.seed), device=device)

    rng = np.random.default_rng(args.seed)
    reqs = []
    for rid in range(args.requests):
        plen = int(rng.integers(4, min(64, args.cache_len // 2)))
        prompt = rng.integers(1, cfg.vocab, size=plen).astype(np.int32)
        req = Request(rid=rid, prompt=prompt, max_new=args.max_new)
        reqs.append(req)
        srv.submit(req)

    t0 = time.time()
    steps = toks = 0
    while srv.queue or any(r is not None for r in srv.slot_req):
        toks += srv.step()
        steps += 1
        if steps > 100_000:
            raise RuntimeError("serve loop did not drain")
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    dt = time.time() - t0
    done = sum(r.done for r in reqs)
    print(f"[serve] {done}/{len(reqs)} requests, {toks} decode-tokens in "
          f"{dt:.1f}s ({toks/max(dt,1e-9):.1f} tok/s), {steps} steps")
    for r in reqs[:3]:
        print(f"  rid={r.rid} prompt[:6]={r.prompt[:6].tolist()} out={r.out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
