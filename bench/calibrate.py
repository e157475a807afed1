"""The readings the limits of a training cell are set from, on the chip
at the cell's own size (no benchmark run calls this):

    python3 bench/calibrate.py --workload <cell> --seeds N [--controls K]
        [--faults F] [--out PATH]

For each of N seeds (from a fixed large base) it drives the program's
set-up (``drive_train.prepare``: the checked steps of the timed path)
and compares it with the plain reference: the program's ``loss_gap``,
``grad_gap`` and ``change_gap``.  On the first K seeds it reads the
control, the reference in TF32 put in the program's place; on the first
F seeds each fault of ``FAULTS`` planted under the program's step.  One
JSON line a reading, then a summary: the largest of the program's
readings (the lower reading of each limit) and the smallest of the
control's and of each fault's (the upper ones).
"""
from __future__ import annotations

import argparse
import gc
import json
import math
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
BASE_SEED = 2**31 + 7


def unchanged(make):
    """A step that returns its state unchanged."""
    def mk(*a, **k):
        step = make(*a, **k)

        def faulty(state, batch):
            return state, step(state, batch)[1]
        return faulty
    return mk


def half_batch(make):
    """Half of the batch left out, the mean taken over the rest."""
    def mk(*a, **k):
        step = make(*a, **k)

        def faulty(state, batch):
            n = batch["tokens"].shape[0] // 2
            return step(state, {key: v[:n] for key, v in batch.items()})
        return faulty
    return mk


def leaf_doubled(make):
    """An answer altered where it is produced: the largest leaf of the new
    parameters moved by twice the optimizer's update."""
    def mk(*a, **k):
        step = make(*a, **k)

        def faulty(state, batch):
            new, metrics = step(state, batch)
            old = _largest(state.params)
            moved = _largest(new.params)
            moved.data.mul_(2).sub_(old)
            return new, metrics
        return faulty
    return mk


def _largest(tree):
    from bench.weights import leaf_items
    return max((t for _, t in leaf_items(tree)), key=lambda t: t.numel())


FAULTS = {"unchanged": unchanged, "half_batch": half_batch,
          "leaf_doubled": leaf_doubled}


def program_readings(c, seed, device, fault=None):
    from bench import drive_train
    from repro_torch.train import trainer

    make = trainer.make_train_step
    if fault:
        trainer.make_train_step = FAULTS[fault](make)
    try:
        run = drive_train.prepare(c, seed, device)
    finally:
        trainer.make_train_step = make
    out = run["readings"]
    del run
    gc.collect()
    if device == "cuda":
        import torch
        torch.cuda.empty_cache()
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--controls", type=int, default=3)
    ap.add_argument("--faults", type=int, default=3)
    ap.add_argument("--fault", action="append", choices=sorted(FAULTS),
                    help="the faults to plant (default: every one)")
    ap.add_argument("--first", type=int, default=0)
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "src"))
    from bench import check, common
    from bench.reference import train as ref_train

    c = common.cell(args.workload)
    out = open(args.out, "a") if args.out else None
    rows = []

    def emit(row):
        rows.append(row)
        line = json.dumps(row)
        print(line, flush=True)
        if out:
            out.write(line + "\n")
            out.flush()

    for i in range(args.first, args.first + args.seeds):
        seed = BASE_SEED + 7919 * i
        t0 = time.perf_counter()
        prog = program_readings(c, seed, "cuda")
        t1 = time.perf_counter()
        ref = ref_train.readings(c["config"], c["traffic"], seed, "cuda")
        t2 = time.perf_counter()
        emit({"cell": args.workload, "seed": seed, "side": "program",
              "gaps": check.gaps(prog, ref), "program_s": t1 - t0,
              "reference_s": t2 - t1, "loss": prog["loss"],
              "ref_loss": ref["loss"]})
        if i - args.first < args.controls:
            ctl = ref_train.readings(c["config"], c["traffic"], seed,
                                     "cuda", tf32=True)
            emit({"cell": args.workload, "seed": seed, "side": "control",
                  "gaps": check.gaps(ctl, ref)})
        if i - args.first < args.faults:
            for f in args.fault or FAULTS:
                emit({"cell": args.workload, "seed": seed, "side": f,
                      "gaps": check.gaps(program_readings(
                          c, seed, "cuda", fault=f), ref)})
    summary = {"cell": args.workload, "summary": {}}
    for side in {r["side"] for r in rows}:
        got = [r["gaps"] for r in rows if r["side"] == side]
        pick = max if side == "program" else min
        summary["summary"][side] = {
            k: pick(g[k] for g in got) for k in check.NAMES}
        summary["summary"][side]["n"] = len(got)
    emit(summary)
    return 0 if all(math.isfinite(v) for r in rows if "gaps" in r
                    for v in r["gaps"].values()) else 1


if __name__ == "__main__":
    sys.exit(main())
