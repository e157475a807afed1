"""Training launcher: the DFRS *job* side.  It checkpoints on schedule and
restarts from the newest checkpoint, the pause/resume contract the
scheduler (``repro_torch.sched``) relies on.

    PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-360m \
        --steps 12 --batch 4 --seq 1024 --ckpt-dir /tmp/ckpt --ckpt-every 4
    PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-360m \
        --reduced --device cpu --steps 20 --batch 4 --seq 64

Runs on the card unless ``--device cpu``; parameters are random, drawn
from ``--seed``, fp32.  ``--report PATH`` (not in the reference's
launcher) writes the run's numbers as JSON: the losses, each step's wall
(ending in a synchronise), the restarts and the steps restored from, the
peak device memory and the kernels' launch counts.
"""
from __future__ import annotations

import argparse
import json
import time

import torch

from ..configs import get_config, get_reduced
from ..device import resolve_device
from ..kernels import ops
from ..train.data import data_for
from ..train.ft import FailureInjector, run_restartable
from ..train.optimizer import OptConfig
from ..train.trainer import init_train_state, make_train_step


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true",
                    help="smoke-scale config (CPU)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--factored", action="store_true")
    ap.add_argument("--compress-grads", action="store_true")
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--inject-failures", default="",
                    help="comma-separated steps at which to fail (FT demo)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--report", default="",
                    help="write the run's numbers to this JSON file")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cuda = device.type == "cuda"
    cfg = get_reduced(args.arch) if args.reduced else get_config(args.arch)
    opt_cfg = OptConfig(lr=args.lr, warmup_steps=max(5, args.steps // 20),
                        total_steps=args.steps, factored=args.factored)
    data = data_for(cfg, args.batch, args.seq, seed=args.seed,
                    n_enc=64 if args.reduced else None, device=device)
    step_fn = make_train_step(cfg, opt_cfg, microbatches=args.microbatches,
                              compress_grads=args.compress_grads)
    walls = []

    def timed_step(state, batch):
        t0 = time.perf_counter()
        state, metrics = step_fn(state, batch)
        if cuda:
            torch.cuda.synchronize(device)
        walls.append(time.perf_counter() - t0)
        return state, metrics

    def new_state():
        gen = torch.Generator(device=device)
        gen.manual_seed(args.seed)
        return init_train_state(cfg, gen, compress=args.compress_grads,
                                factored=args.factored, device=device)

    ops.reset_launches()
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    report = {}
    if args.ckpt_dir:
        fails = tuple(int(x) for x in args.inject_failures.split(",") if x)
        rep = run_restartable(
            train_step=timed_step, init_state=new_state,
            batch_for_step=data.batch_for_step, total_steps=args.steps,
            ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every,
            injector=FailureInjector(at_steps=fails) if fails else None)
        print(f"[train] done: step {rep.final_step}, {rep.n_restarts} restarts, "
              f"loss {rep.losses[0]:.4f} -> {rep.losses[-1]:.4f}, "
              f"stragglers {rep.straggler.n_stragglers}")
        report = {"final_step": rep.final_step, "n_restarts": rep.n_restarts,
                  "restored_from": rep.restored_from, "losses": rep.losses,
                  "stragglers": rep.straggler.n_stragglers}
    else:
        state = new_state()
        t0 = time.time()
        losses = []
        for i in range(args.steps):
            state, m = timed_step(state, data.batch_for_step(i))
            losses.append(float(m["loss"]))
            if i % args.log_every == 0 or i == args.steps - 1:
                print(f"[train] step {i:5d} loss {losses[-1]:.4f} "
                      f"gnorm {float(m['grad_norm']):.3f} "
                      f"({(time.time()-t0)/(i+1)*1e3:.0f} ms/step)")
        report = {"final_step": args.steps, "losses": losses}
    if args.report:
        report.update(
            arch=cfg.name, device=str(device), batch=args.batch,
            seq=args.seq, step_s=walls,
            peak_bytes=torch.cuda.max_memory_allocated(device) if cuda else 0,
            launches=dict(ops.launches),
            routes={k: dict(v) for k, v in ops.routes.items()})
        with open(args.report, "w") as f:
            json.dump(report, f)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
