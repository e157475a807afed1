#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py            # from the root of a checkout

It imports the port only.  The CUDA kernels are built from the sources in
the checkout at first use (``build/repro_torch/``).  Phases, one JSON line
each; the first phase that fails ends the run with exit code 1:

1. device    — the card's name and power limit (nvidia-smi), kernel build;
2. kernels   — each CUDA kernel against its plain PyTorch version on the
               card, bit for bit (the matvec also against a numpy loop;
               the round on bottlenecks made of near-ties, and most lanes
               must bind on a near-tie that is not exact);
3. allocator — the batched OPT=MIN water-filling and the OPT=AVG floor on
               the card against the numpy kernels, 200 seeded random
               incidences each, bit for bit;
4. slice     — ``run_batched`` over paper-size cells (Lublin, 1000 jobs,
               128 nodes, load 0.7: OPT=MIN seeds, two OPT=AVG cells, two
               EASY cells) on the card; every outcome field of every record
               must equal the host numpy ``Engine`` run of the same cell
               (timed, with its allocation share);
               the kernel launch counts are zeroed just before and read just
               after; ``torch.profiler`` traces the card's activity over the
               run for the device's busy share;
5. kernels line — per kernel: launches in phase 4, the largest difference
               from its plain version, device times (CUDA events around a
               CUDA graph of many launches) of the kernel, its plain version
               and a library call computing the same function, and the
               least time the card could take (bytes over 3.35 TB/s or FP64
               operations over 34 TFLOP/s, whichever is larger, counting
               what these inputs need: the round reads the presence rows of
               its binding nodes only).

Then the nvidia-smi line again, the kernels line, and last
``{"ok": true, "device": {...}}``.  Without a CUDA device, or without the
port beside this script, it exits non-zero and prints no result.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
import traceback
from collections import Counter
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# NVIDIA H100 SXM data sheet: HBM3 bandwidth and FP64 (non-tensor) peak
HBM_BYTES_PER_S = 3.35e12
FP64_OPS_PER_S = 34e12

N_JOBS, N_NODES, LOAD = 1000, 128, 0.7
MIN_SEEDS = 16          # GreedyP */OPT=MIN cells in phase 4

_NEED_EPS, _TIE_TOL, _CAP_TOL = 1e-12, 1e-15, 1e-12   # as in the round

_OUTCOMES = ("max_stretch", "mean_stretch", "makespan", "underutilization",
             "n_pmtn", "n_mig", "pmtn_per_job", "mig_per_job",
             "pmtn_per_hour", "mig_per_hour", "bytes_moved_gb",
             "bandwidth_gbps", "events", "hit_max_events", "final_time")


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


class PhaseFailed(Exception):
    pass


# --------------------------------------------------------------------------- #
# inputs                                                                       #
# --------------------------------------------------------------------------- #
def incidence_batch(rng, B, N, W):
    """(B, N, W) float64 weights shaped like engine incidences: cpu needs in
    {0, .25, .5, 1} times multiplicities 1..3, most entries empty."""
    import numpy as np
    need = rng.choice([0.0, 0.25, 0.5, 1.0], (B, 1, W))
    mult = rng.integers(0, 4, (B, N, W)) * (rng.random((B, N, W)) < 0.2)
    return need * mult.astype(np.float64)


def round_inputs(rng, B, N, W):
    """Inputs of one freeze round whose bottleneck is a cluster of near-ties.

    A quarter of the nodes (need 1) sit at the lane's base level plus a
    multiple of 0.3e-15 up to 3e-15 either way, so the binding set mixes
    exact ties, levels within the 1e-15 scan tolerance and levels just
    beyond it, and depends on the scan order.  Every other node has a level
    in [0.45, 0.5], above all planted ones, or no need.  A tenth of the
    lanes has no need at all, so its level caps at 1."""
    import numpy as np
    base = rng.uniform(0.05, 0.4, (B, 1))
    planted = rng.random((B, N)) < 0.25
    offs = rng.integers(-10, 11, (B, N)) * 0.3e-15
    u_other = rng.choice([0.0, 0.5, 2.0], (B, N))
    level_other = rng.uniform(0.45, 0.5, (B, N))
    u_need = np.where(planted, 1.0, u_other)
    f_use = np.where(planted, 1.0 - (base + offs),
                     1.0 - level_other * u_other)
    u_need[rng.random(B) < 0.1] = 0.0
    present = rng.random((B, N, W)) < 0.2
    frozen = rng.random((B, W)) < 0.3
    y = np.where(frozen, rng.random((B, W)), 0.0)
    live = rng.random(B) < 0.9
    return f_use, u_need, present, frozen, y, live


def binding_sets(f_use, u_need, live):
    """The bottleneck scan of one round in numpy, lane by lane in node
    order.  Per live lane ``(binding node ids, near_tie)``: the ids are
    empty when the level caps at 1, and ``near_tie`` says that the set
    holds two or more nodes, one of them within the tolerance of the level
    but not equal to it.  ``None`` for a lane that is not live."""
    import numpy as np
    valid = u_need > _NEED_EPS
    levels = np.maximum(0.0, 1.0 - f_use) / np.where(valid, u_need, 1.0)
    out = []
    for b in range(f_use.shape[0]):
        if not live[b]:
            out.append(None)
            continue
        best, binding = 1.0, []
        for n in np.nonzero(valid[b])[0]:
            lvl = levels[b, n]
            if lvl < best - _TIE_TOL:
                best, binding = lvl, [int(n)]
            elif abs(lvl - best) <= _TIE_TOL:
                binding.append(int(n))
        if best >= 1.0 - _CAP_TOL:
            binding = []
        near = len(binding) > 1 and any(levels[b, n] != best for n in binding)
        out.append((binding, near))
    return out


def random_instance(rng, build_csr, max_width=30, max_nodes=12):
    """A random incidence: varied width, zero-need jobs, dead nodes,
    multiplicities > 1, possibly empty running set."""
    import numpy as np
    W = int(rng.integers(1, max_width + 1))
    N = int(rng.integers(1, max_nodes + 1))
    run = np.sort(rng.choice(W, int(rng.integers(0, W + 1)), replace=False))
    cpu = rng.choice([0.0, 0.25, 0.5, 1.0], W)
    alive = np.nonzero(rng.random(N) > 0.15)[0]
    if alive.size == 0:
        alive = np.array([0])
    mappings = [[] for _ in range(W)]
    for j in run:
        mappings[j] = list(rng.choice(alive, int(rng.integers(1, 5)),
                                      replace=True))
    inc = build_csr(cpu, mappings, N)
    active = np.zeros(W, dtype=bool)
    active[run] = True
    return inc, active


# --------------------------------------------------------------------------- #
# timing                                                                       #
# --------------------------------------------------------------------------- #
def device_ms(torch, fn, iters):
    """Device milliseconds per call: ``iters`` calls captured in one CUDA
    graph (so host launch cost is not counted), replayed once after a
    warm-up replay, between two CUDA events."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    end.synchronize()
    ms = start.elapsed_time(end) / iters
    del graph
    return ms


def eager_ms(torch, fn, iters):
    """Milliseconds per call as a host loop issues them (host launch cost
    included): CUDA events around ``iters`` eager calls after a warm-up."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def bound_ms(n_bytes, n_ops):
    by_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    by_ops = n_ops / FP64_OPS_PER_S * 1e3
    return (max(by_bytes, by_ops), "bytes" if by_bytes >= by_ops
            else "operations")


# --------------------------------------------------------------------------- #
# phases                                                                       #
# --------------------------------------------------------------------------- #
def phase_device(torch, cuda_lib):
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip()
    smi_line = smi.splitlines()[0] if smi else "nvidia-smi: no output"
    print(smi_line, flush=True)
    t0 = time.perf_counter()
    cuda_lib.load_library()
    build_s = time.perf_counter() - t0
    info = cuda_lib.build_info()
    ptxas = [ln.strip() for ln in info["log"].splitlines()
             if "registers" in ln or "spill" in ln]
    emit({"phase": "device", "ok": True, "nvidia_smi": smi_line,
          "kind": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(),
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "build_s": build_s, "build_cached": info["cached"],
          "library": info["path"], "ptxas": ptxas})
    return smi_line


def phase_kernels(torch, np):
    from repro_torch.kernels.alloc_matvec import (alloc_matvec_cuda,
                                                  alloc_matvec_plain)
    from repro_torch.kernels.maxmin_round import (maxmin_round_cuda,
                                                  maxmin_round_plain)

    dev = torch.device("cuda")
    rng = np.random.default_rng(2011)
    checks = []
    for shape in [(32, 128, 64), (128, 128, 128), (3, 5, 37), (4, 16, 0)]:
        B, N, W = shape
        w = incidence_batch(rng, B, N, W)
        x = rng.random((B, W))
        wt, xt = torch.from_numpy(w).to(dev), torch.from_numpy(x).to(dev)
        k = alloc_matvec_cuda(wt, xt)
        p = alloc_matvec_plain(wt, xt)
        torch.cuda.synchronize()
        acc = np.zeros((B, N))
        for j in range(W):                      # numpy sequential loop
            acc = acc + w[:, :, j] * x[:, None, j]
        checks.append({"kernel": "alloc_matvec", "shape": list(shape),
                       "equal_plain": bool(torch.equal(k, p)),
                       "equal_numpy": bool(np.array_equal(k.cpu().numpy(),
                                                          acc))})
    for shape in [(32, 128, 64), (16, 128, 64), (3, 5, 37), (4, 16, 0)]:
        arrays = round_inputs(rng, *shape)
        args = [torch.from_numpy(a).to(dev) for a in arrays]
        ky, kf = maxmin_round_cuda(*args)
        py, pf = maxmin_round_plain(*args)
        torch.cuda.synchronize()
        sets = [s for s in binding_sets(arrays[0], arrays[1], arrays[5])
                if s is not None and s[0]]
        near = sum(s[1] for s in sets)
        check = {"kernel": "maxmin_round", "shape": list(shape),
                 "equal_plain": bool(torch.equal(ky, py)
                                     and torch.equal(kf, pf)),
                 "binding_lanes": len(sets), "near_tie_lanes": near}
        if shape[1] == N_NODES:     # at the cluster's width, most lanes
            check["near_ties_ok"] = 2 * near > len(sets)
        checks.append(check)
    ok = all(c["equal_plain"] and c.get("equal_numpy", True)
             and c.get("near_ties_ok", True) for c in checks)
    emit({"phase": "kernels", "ok": ok, "tolerance": "bit-exact",
          "checks": checks})
    if not ok:
        raise PhaseFailed("a kernel disagrees with its plain version, or "
                          "the round's inputs hold too few near-ties")


def phase_allocator(torch, np):
    from repro_torch.core import alloc_torch
    from repro_torch.core.alloc_kernels import (avg_yields_csr, build_csr,
                                                maxmin_yields_csr)

    rng = np.random.default_rng(7)
    insts = [random_instance(rng, build_csr) for _ in range(200)]
    dev = torch.device("cuda")
    # all 200 as lanes of one padded batch
    present, weight, active = alloc_torch.pad_batch(
        [i for i, _ in insts], [a for _, a in insts])
    y = alloc_torch.maxmin_yields_batch(
        torch.from_numpy(present).to(dev), torch.from_numpy(weight).to(dev),
        torch.from_numpy(active).to(dev)).cpu().numpy()
    min_batch_bad = sum(
        not np.array_equal(y[b, : inc.width], maxmin_yields_csr(inc, act))
        for b, (inc, act) in enumerate(insts))
    # through the allocator protocol, 25 requests per dispatch
    alloc = alloc_torch.TorchBatchedAllocator(device="cuda")
    min_bad = avg_bad = n_avg = 0
    for lo in range(0, len(insts), 25):
        chunk = insts[lo:lo + 25]
        reqs = [(inc, np.nonzero(act)[0].astype(np.int64), "MIN")
                for inc, act in chunk]
        for (inc, act), got in zip(chunk, alloc.allocate_many(reqs)):
            min_bad += not np.array_equal(
                got, maxmin_yields_csr(inc, act)[np.nonzero(act)[0]])
        reqs = [(inc, np.nonzero(act)[0].astype(np.int64), "AVG")
                for inc, act in chunk]
        for (inc, act), got in zip(chunk, alloc.allocate_many(reqs)):
            cols = np.nonzero(act)[0].astype(np.int64)
            avg_bad += not np.array_equal(got, avg_yields_csr(inc, cols))
            n_avg += bool(cols.size)
    ok = min_batch_bad == 0 and min_bad == 0 and avg_bad == 0
    emit({"phase": "allocator", "ok": ok, "instances": len(insts),
          "avg_nonempty": n_avg, "min_one_batch_mismatches": min_batch_bad,
          "min_allocator_mismatches": min_bad,
          "avg_allocator_mismatches": avg_bad, "tolerance": "bit-exact"})
    if not ok:
        raise PhaseFailed("the allocator disagrees with the numpy kernels")


class TimedHostAlloc:
    """The host numpy allocation path (``allocate_incidence``, what an
    ``Engine`` with no backend calls), timed: splits a host run into
    allocation and the rest of the engine."""

    def __init__(self):
        from repro_torch.core.yield_alloc import allocate_incidence
        self._allocate = allocate_incidence
        self.seconds = 0.0

    def allocate(self, inc, cols, opt="MIN"):
        t0 = time.perf_counter()
        y = self._allocate(inc, cols, opt=opt)
        self.seconds += time.perf_counter() - t0
        return y


def start_device_trace(torch):
    """A started ``torch.profiler`` recording the card's activity only, or
    the reason it could not start."""
    try:
        prof = torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA])
        prof.start()
        return prof, None
    except Exception as exc:  # noqa: BLE001 — the share is then not measured
        return None, f"{type(exc).__name__}: {exc}"


def device_busy(prof, wall_s):
    """What the trace saw of the card: seconds in which a kernel or a copy
    ran (the union of their intervals), that over ``wall_s``, and seconds
    summed by kind (the port's kernels, other kernels, copies)."""
    spans, by_kind = [], Counter()
    for e in prof.events():
        if not str(e.device_type).endswith("CUDA"):
            continue
        start, end = e.time_range.start, e.time_range.end
        spans.append((start, end))
        if e.name.startswith(("Memcpy", "Memset")):
            kind = "copies"
        elif "alloc_matvec_kernel" in e.name or "maxmin_round_kernel" in e.name:
            kind = "port_kernels"
        else:
            kind = "other_kernels"
        by_kind[kind] += (end - start) / 1e6
    if not spans:
        return {"busy_s": None, "busy_share": None, "device_events": 0,
                "note": "the trace holds no device activity: not measured"}
    spans.sort()
    busy_us, (lo, hi) = 0.0, spans[0]
    for start, end in spans[1:]:
        if start > hi:
            busy_us += hi - lo
            lo, hi = start, end
        else:
            hi = max(hi, end)
    busy_us += hi - lo
    return {"busy_s": busy_us / 1e6, "busy_share": busy_us / 1e6 / wall_s,
            "device_events": len(spans), "summed_s": dict(by_kind)}


def phase_slice(torch, np):
    from repro_torch.kernels import ops
    from repro_torch.sched.engine import Engine, SimParams
    from repro_torch.sched.sweep import Cell, run_batched
    from repro_torch.workloads.registry import WorkloadSpec, make_trace_ir

    def w(seed):
        return WorkloadSpec("lublin", n_jobs=N_JOBS, n_nodes=N_NODES,
                            seed=seed, load=LOAD)

    cells = ([Cell(w(s), "GreedyP */OPT=MIN") for s in range(MIN_SEEDS)]
             + [Cell(w(s), "Greedy */OPT=AVG") for s in range(2)]
             + [Cell(w(s), "EASY") for s in range(2)])
    for c in cells:
        make_trace_ir(c.workload)               # traces are set-up, not run
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    prof, trace_error = start_device_trace(torch)
    ops.reset_launches()
    t0 = time.perf_counter()
    res = run_batched(cells, device="cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(ops.launches)
    peak = torch.cuda.max_memory_allocated()
    if prof is None:
        busy = {"busy_s": None, "busy_share": None,
                "note": f"the profiler did not start ({trace_error}): "
                        f"not measured"}
    else:
        try:
            prof.stop()
            busy = device_busy(prof, wall)
        except Exception as exc:  # noqa: BLE001 — then not measured
            busy = {"busy_s": None, "busy_share": None,
                    "note": f"{type(exc).__name__}: {exc}: not measured"}
        del prof

    t1 = time.perf_counter()
    host_alloc = TimedHostAlloc()
    mismatches = []
    for c, rec in zip(cells, res.records):
        ref = Engine(make_trace_ir(c.workload), c.policy,
                     SimParams(n_nodes=N_NODES),
                     alloc_backend=host_alloc).run()
        bad = [k for k in _OUTCOMES if rec[k] != getattr(ref, k)]
        if not np.isfinite(rec["max_stretch"]) or rec["max_stretch"] < 1.0:
            bad.append("max_stretch not finite and >= 1")
        if bad:
            mismatches.append({"cell": c.name, "fields": bad})
    host_wall = time.perf_counter() - t1
    stats = res.alloc_stats
    ok = not mismatches and all(v > 0 for v in launches.values())
    emit({"phase": "slice", "ok": ok, "cells": len(cells),
          "min_seeds": MIN_SEEDS,
          "n_jobs": N_JOBS, "n_nodes": N_NODES, "load": LOAD,
          "wall_s": wall, "cells_per_s": len(cells) / wall,
          "device": busy,
          "dispatches": stats["dispatches"], "rounds": stats["rounds"],
          "host_syncs": stats["host_syncs"], "launches": launches,
          "serve_min_s": stats["min_s"], "serve_avg_s": stats["avg_s"],
          "max_memory_allocated_bytes": peak,
          "min_shapes": {str(k): v for k, v
                         in stats["min_shapes"].most_common(6)},
          "avg_shapes": {str(k): v for k, v
                         in stats["avg_shapes"].most_common(6)},
          "host_reference_wall_s": host_wall,
          "host_reference_alloc_s": host_alloc.seconds,
          "mismatches": mismatches,
          "max_stretch": [rec["max_stretch"] for rec in res.records]})
    if not ok:
        raise PhaseFailed("the slice disagrees with the host run or did not "
                          "reach a kernel")
    return launches, stats


def phase_kernel_line(torch, np, launches, stats):
    from repro_torch.kernels.alloc_matvec import (alloc_matvec_cuda,
                                                  alloc_matvec_plain)
    from repro_torch.kernels.maxmin_round import (maxmin_round_cuda,
                                                  maxmin_round_plain)

    dev = torch.device("cuda")
    rng = np.random.default_rng(11)
    shapes = Counter(stats["min_shapes"]) + Counter(stats["avg_shapes"])
    mv_shape = shapes.most_common(1)[0][0]
    rd_shape = stats["min_shapes"].most_common(1)[0][0]

    B, N, W = mv_shape
    wt = torch.from_numpy(incidence_batch(rng, B, N, W)).to(dev)
    xt = torch.from_numpy(rng.random((B, W))).to(dev)
    k = alloc_matvec_cuda(wt, xt)
    p = alloc_matvec_plain(wt, xt)
    lib = torch.bmm(wt, xt[:, :, None])[:, :, 0]
    mv_bound, mv_by = bound_ms(8 * (B * N * W + B * W + B * N), 2 * B * N * W)
    matvec = {
        "name": "alloc_matvec", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/alloc.cu",
        "wrapper": "src/repro_torch/kernels/alloc_matvec.py",
        "replaces": "src/repro/kernels/alloc_matvec.py:65",
        "launches": launches["alloc_matvec"], "shape": [B, N, W],
        "max_abs_err": float((k - p).abs().max()) if k.numel() else 0.0,
        "library_max_abs_diff": float((k - lib).abs().max()),
        "ms": device_ms(torch, lambda: alloc_matvec_cuda(wt, xt), 200),
        "eager_ms": eager_ms(torch, lambda: alloc_matvec_cuda(wt, xt), 200),
        "plain_ms": device_ms(torch, lambda: alloc_matvec_plain(wt, xt), 20),
        "library": "torch.bmm",
        "library_ms": device_ms(
            torch, lambda: torch.bmm(wt, xt[:, :, None]), 200),
        "bound_ms": mv_bound, "bound_by": mv_by,
    }

    B, N, W = rd_shape
    arrays = round_inputs(rng, B, N, W)
    args = [torch.from_numpy(a).to(dev) for a in arrays]
    ky, kf = maxmin_round_cuda(*args)
    py, pf = maxmin_round_plain(*args)
    err = float((ky - py).abs().max()) if ky.numel() else 0.0
    if not torch.equal(kf, pf):
        err = float("inf")
    f_use, u_need, live = arrays[0], arrays[1], arrays[5]
    n_live = int(live.sum())
    n_valid = int(((u_need > _NEED_EPS) & live[:, None]).sum())
    n_binding = sum(len(s[0]) for s in binding_sets(f_use, u_need, live)
                    if s is not None)
    # bytes: f_use and u_need of live lanes, the presence rows of their
    # binding nodes, frozen, y and live in; y and frozen out.  Operations:
    # at most 11 FP64 ops per valid node of a live lane (level, drop test,
    # tie test)
    rd_bound, rd_by = bound_ms(
        16 * n_live * N + n_binding * W + B * W + 8 * B * W + B
        + 8 * B * W + B * W,
        11 * n_valid)
    round_ = {
        "name": "maxmin_round", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/alloc.cu",
        "wrapper": "src/repro_torch/kernels/maxmin_round.py",
        "replaces": "src/repro/core/alloc_jax.py:229",
        "launches": launches["maxmin_round"], "shape": [B, N, W],
        "max_abs_err": err,
        "ms": device_ms(torch, lambda: maxmin_round_cuda(*args), 200),
        "eager_ms": eager_ms(torch, lambda: maxmin_round_cuda(*args), 200),
        "plain_ms": device_ms(torch, lambda: maxmin_round_plain(*args), 5),
        "library": None, "library_ms": None,
        "bound_ms": rd_bound, "bound_by": rd_by,
        "binding_rows": n_binding,
    }
    kernels = [matvec, round_]
    ok = all(e["launches"] > 0 and e["max_abs_err"] == 0.0 for e in kernels)
    return {"kernels": kernels}, ok


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    try:
        from repro_torch.kernels import cuda_lib
    except ImportError as exc:
        print(f"chip_smoke: the port (src/repro_torch) is not beside this "
              f"script: {exc}", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False

    phase = "device"
    try:
        smi_line = phase_device(torch, cuda_lib)
        phase = "kernels"
        phase_kernels(torch, np)
        phase = "allocator"
        phase_allocator(torch, np)
        phase = "slice"
        launches, stats = phase_slice(torch, np)
        phase = "kernels line"
        line, ok = phase_kernel_line(torch, np, launches, stats)
    except Exception as exc:  # noqa: BLE001 — reported, then a failing exit
        traceback.print_exc()
        emit({"phase": phase, "ok": False,
              "error": f"{type(exc).__name__}: {exc}"})
        return 1
    print(smi_line, flush=True)
    emit(line)
    if not ok:
        print("chip_smoke: a kernel was not launched on the main path or "
              "disagrees with its plain version", file=sys.stderr)
        return 1
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
