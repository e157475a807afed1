#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py            # from the root of a checkout

It imports the port only.  The CUDA kernels are built from the sources in
the checkout at first use (``build/repro_torch/``), one ``nvcc`` per source,
all started together.  Phases, one JSON line each; the first phase that
fails ends the run with exit code 1:

1. device    — the card's name and power limit (nvidia-smi), the build of
               every kernel library (seconds; ptxas registers and spills
               of every kernel function), and the HGMMA instructions in
               the SASS of the tensor-core prefill instances (cuobjdump;
               the phase fails if there are none);
2. kernels   — each allocation kernel against its plain PyTorch version on
               the card, bit for bit (the matvec also against a numpy loop;
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
               run for the device's busy share; peak device memory is
               counted from the allocation at the phase's start;
5. serve kernels — flash attention, flash decode, the RG-LRU scan and the
               RWKV6 WKV recurrence against their plain versions on the
               card, fp32 and bf16, at RecurrentGemma-2B's shapes (a prompt
               of 2,100 tokens under the 2,048 window), without a window,
               non-causal, at Llama-3-8B's GQA widths, per-request decode
               lengths past the cache, T = 1 and a long T; bf16 cases
               that reach every attention instance and edge (hd 32 to
               256, hdv != hd, a prompt shorter than a key tile, GQA with
               B > 1, decode lengths 0, S - 1, S and past S, groups of 1,
               4, 10, 32 and 64 heads), each with its route; and at
               RWKV6-7B's (a decode step of 4 slots, a prefill of 2,000
               tokens, a ragged dk != dv, decays down to 1e-3 over 2,000
               steps, the state written in place) (fp32 2e-5, bf16 2e-2,
               the RG-LRU atol 1e-5 / rtol 1e-4, the WKV atol = rtol =
               1e-4: the reference's kernel tolerances);
6. model check — per arch at full width, cut in depth, fp32, seeded
               weights drawn on the host: RecurrentGemma-2B one super-block
               deep (RG-LRU, RG-LRU, local attention), prefill of 2,100
               tokens; RWKV6-7B 2 layers deep, prefill of 1,000 tokens;
               then 8 decode steps, on the card (kernels) and on the host
               CPU (plain versions), logits compared (atol = rtol = 2e-3)
               and greedy tokens counted;
7. serve     — per arch at full width and depth (bf16 weights and cache)
               through ``BatchedServer``, 4 slots, cache 4096, 8 requests
               of 1,024-2,000 prompt tokens: RecurrentGemma-2B (26 layers)
               with 96 new tokens each, so that decode wraps the 2,048
               ring; RWKV6-7B (32 layers) with 64; every request must
               finish with finite logits, and the launch counts, zeroed
               just before and read just after, must show every kernel of
               the arch; then the serve's last wave (its last 4 requests,
               the served prompts) is replayed on a fresh server under
               ``torch.profiler`` for the card's busy share and kernel time
               by name;
8. kernels line — per kernel: launches on its path (phase 4 or 7), the
               largest difference from its plain version, device times
               (CUDA events around a CUDA graph of many launches) of the
               kernel, its plain version and a library call computing the
               same function, and the least time the card could take
               (bytes over 3.35 TB/s, or operations over the rate of the
               inputs' precision — bf16 on the tensor cores for bf16
               inputs, whatever the kernel itself uses — whichever is
               larger, counting what these inputs need); the attention
               entries also name the instance that ran (its route, the
               ptxas registers and spills of its functions) and split
               their device time by kernel name.

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

# NVIDIA H100 SXM data sheet: HBM3 bandwidth, FP64 and FP32 (non-tensor)
# peaks, bf16 dense tensor-core peak
HBM_BYTES_PER_S = 3.35e12
FP64_OPS_PER_S = 34e12
FP32_OPS_PER_S = 67e12
BF16_TC_OPS_PER_S = 989e12

N_JOBS, N_NODES, LOAD = 1000, 128, 0.7
MIN_SEEDS = 16          # GreedyP */OPT=MIN cells in phase 4 (slice)

_NEED_EPS, _TIE_TOL, _CAP_TOL = 1e-12, 1e-15, 1e-12   # as in the round

# the port's kernels, by the names the profiler gives them
_PORT_KERNELS = ("alloc_matvec_kernel", "maxmin_round_kernel", "attn_kernel",
                 "attn_wgmma_kernel", "decode_kernel", "decode_mma_kernel",
                 "decode_combine_kernel", "rglru_scan_kernel", "wkv6_kernel")

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


def device_us_by_kernel(torch, fn, iters):
    """Device microseconds per call of each kernel that ``fn`` launches
    (``torch.profiler`` over ``iters`` eager calls after a warm-up; a
    second trace when the first saw no device activity), or why it was
    not measured."""
    fn()
    torch.cuda.synchronize()
    try:
        for _ in range(2):
            with torch.profiler.profile(
                    activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
                for _ in range(iters):
                    fn()
                torch.cuda.synchronize()
            us = {e.key[:80]: e.device_time_total / iters
                  for e in prof.key_averages() if e.device_time_total > 0}
            if us:
                return us
        return {"note": "the traces held no device activity: not measured"}
    except Exception as exc:  # noqa: BLE001 — then not measured
        return {"note": f"{type(exc).__name__}: {exc}: not measured"}


def bound_ms(n_bytes, n_ops, ops_per_s=FP64_OPS_PER_S):
    by_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    by_ops = n_ops / ops_per_s * 1e3
    return (max(by_bytes, by_ops), "bytes" if by_bytes >= by_ops
            else "operations")


# --------------------------------------------------------------------------- #
# phases                                                                       #
# --------------------------------------------------------------------------- #
def ptxas_functions(log):
    """Per kernel function of a build log (``-Xptxas -v``): registers and
    the bytes of spill stores and loads."""
    out, name = {}, None
    for ln in log.splitlines():
        if "Compiling entry function" in ln:
            name = ln.split("'")[1]
            out[name] = {}
        elif name and "spill stores" in ln:
            words = ln.replace(",", " ").split()
            out[name]["spill_stores"] = int(words[words.index("spill") - 2])
            out[name]["spill_loads"] = int(words[-4])
        elif name and "Used" in ln and "registers" in ln:
            words = ln.replace(",", " ").split()
            out[name]["registers"] = int(words[words.index("registers") - 1])
    return out


def ptxas_of(functions, fragment):
    """The ptxas entry of the one function whose mangled name holds
    ``fragment`` (a template instance, e.g. ``attn_wgmma_kernelILi4E``)."""
    hits = [dict(v, function=k) for k, v in functions.items()
            if fragment in k]
    if len(hits) != 1:
        raise PhaseFailed(f"{len(hits)} kernel functions match {fragment}")
    return hits[0]


def sass_counts(cuda_lib, lib_path, opcode):
    """Instructions of ``opcode`` per kernel function in a built library's
    SASS, by ``cuobjdump`` from the toolkit that built it."""
    tool = Path(cuda_lib._nvcc()).parent / "cuobjdump"
    sass = subprocess.run([str(tool), "-sass", lib_path], capture_output=True,
                          text=True, timeout=300, check=True).stdout
    counts, name = Counter(), None
    for ln in sass.splitlines():
        if "Function :" in ln:
            name = ln.split("Function :")[1].strip()
        elif name and opcode in ln:
            counts[name] += 1
    return counts


def phase_device(torch, cuda_lib):
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip()
    smi_line = smi.splitlines()[0] if smi else "nvidia-smi: no output"
    print(smi_line, flush=True)
    t0 = time.perf_counter()
    cuda_lib.load_all()
    build_s = time.perf_counter() - t0
    info = cuda_lib.build_info()
    libraries = {
        name: {"build_s": lib["build_s"], "cached": lib["cached"],
               "path": lib["path"], "flags": lib["flags"],
               "ptxas": ptxas_functions(lib["log"])}
        for name, lib in info.items()}
    hgmma = {k: v for k, v in sass_counts(
        cuda_lib, info["attention"]["path"], "HGMMA").items()
        if "attn_wgmma_kernel" in k}
    ok = len(hgmma) == 4 and all(v > 0 for v in hgmma.values())
    emit({"phase": "device", "ok": ok, "nvidia_smi": smi_line,
          "kind": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(),
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "build_s": build_s, "libraries": libraries,
          "hgmma_per_prefill_instance": hgmma})
    if not ok:
        raise PhaseFailed("the tensor-core prefill instances hold no HGMMA")
    return smi_line, libraries, hgmma


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
    ran (the union of their intervals), that over ``wall_s``, seconds
    summed by kind (the port's kernels, other kernels, copies), the eight
    names with the most summed seconds and the port's kernels by name."""
    spans, by_kind, by_name, by_port = [], Counter(), Counter(), Counter()
    for e in prof.events():
        if not str(e.device_type).endswith("CUDA"):
            continue
        start, end = e.time_range.start, e.time_range.end
        spans.append((start, end))
        if e.name.startswith(("Memcpy", "Memset")):
            kind = "copies"
        elif any(k in e.name for k in _PORT_KERNELS):
            kind = "port_kernels"
            by_port[e.name[:80]] += (end - start) / 1e6
        else:
            kind = "other_kernels"
        by_kind[kind] += (end - start) / 1e6
        by_name[e.name[:80]] += (end - start) / 1e6
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
            "device_events": len(spans), "summed_s": dict(by_kind),
            "top_kernels_s": dict(by_name.most_common(8)),
            "port_kernels_s": dict(by_port.most_common())}


def host_ops(torch, fn):
    """Top-level ATen operators that one call of ``fn`` dispatches from the
    host (each a launch, or more, when its tensors lie on the card)."""
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        fn()
    return sum(e.name.startswith("aten::") and (
        e.cpu_parent is None or not e.cpu_parent.name.startswith("aten::"))
        for e in prof.events())


def stop_device_trace(prof, trace_error, wall_s):
    """:func:`device_busy` of a trace from :func:`start_device_trace`, or
    why it was not measured."""
    if prof is None:
        return {"busy_s": None, "busy_share": None,
                "note": f"the profiler did not start ({trace_error}): "
                        f"not measured"}
    try:
        prof.stop()
        return device_busy(prof, wall_s)
    except Exception as exc:  # noqa: BLE001 — then not measured
        return {"busy_s": None, "busy_share": None,
                "note": f"{type(exc).__name__}: {exc}: not measured"}


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
    base = torch.cuda.memory_allocated()
    prof, trace_error = start_device_trace(torch)
    ops.reset_launches()
    t0 = time.perf_counter()
    res = run_batched(cells, device="cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k: ops.launches[k] for k in ("alloc_matvec", "maxmin_round")}
    peak = torch.cuda.max_memory_allocated() - base
    busy = stop_device_trace(prof, trace_error, wall)
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
          "allocated_before_bytes": base,
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


# --------------------------------------------------------------------------- #
# the serving path (RecurrentGemma-2B, RWKV6-7B)                               #
# --------------------------------------------------------------------------- #
RG, RWKV = "recurrentgemma-2b", "rwkv6-7b"
# per arch: the kernels its path launches, the model check's depth, prompt
# and weight seed, the serve's new tokens a request and its seed
SERVE_ARCHS = {
    RG: {"kernels": ("flash_attention", "flash_decode", "rglru_scan"),
         "check_layers": 3, "check_prompt": 2100, "check_seed": 2402,
         # three of seed 60's eight prompts decode past the 2,048 window
         "max_new": 96, "seed": 60},
    RWKV: {"kernels": ("wkv6",),
           "check_layers": 2, "check_prompt": 1000, "check_seed": 2404,
           "max_new": 64, "seed": 64},
}
TOL = {"float32": 2e-5, "bfloat16": 2e-2}      # the reference's kernel tests
RGLRU_ATOL, RGLRU_RTOL = 1e-5, 1e-4
WKV_TOL = 1e-4                                 # atol = rtol
MODEL_TOL = 2e-3                               # the reference's model tests
CHECK_STEPS, CHECK_CACHE = 8, 4096
SERVE_SLOTS, SERVE_CACHE, SERVE_REQUESTS = 4, 4096, 8


def _dtype_name(torch, dt):
    return {torch.float32: "float32", torch.bfloat16: "bfloat16"}[dt]


def _err(a, b):
    return float((a.float() - b.float()).abs().max()) if a.numel() else 0.0


def _within(torch, a, b, atol, rtol):
    a, b = a.float(), b.float()
    return bool(((a - b).abs() <= atol + rtol * b.abs()).all())


def _randn(torch, gen, shape, dtype):
    return torch.randn(shape, generator=gen, device="cuda").to(dtype)


def wkv6_inputs(torch, gen, B, T, H, dk, dv, dtype, w_low):
    """r, k, v (in ``dtype``), w in [w_low, 1), u and s0 as the model
    feeds the WKV recurrence."""
    def rand(shape, scale):
        return _randn(torch, gen, shape, torch.float32) * scale
    w = w_low + (1.0 - w_low) * torch.rand((B, T, H, dk), generator=gen,
                                           device="cuda")
    return (rand((B, T, H, dk), 0.5).to(dtype),
            rand((B, T, H, dk), 0.5).to(dtype),
            rand((B, T, H, dv), 0.5).to(dtype), w, rand((H, dk), 0.5),
            rand((B, H, dk, dv), 0.1))


def wkv6_bound(r, v):
    """(bound ms, what bounds it) of one WKV call: r, k, v read in their
    type, w, u and s0 in fp32, y and sT written in fp32.  The operations
    are what the function needs at each step of each head: with the bonus
    as one dot product, y_j = sum_i r_i s_ij + v_j sum_i r_i u_i k_i, 5
    flops for each (row i, column j) pair (r s, w s, k v), 3 for each row
    (r u k) and 2 for each column (v times the bonus, added to y_j)."""
    B, T, H, dk = r.shape
    dv = v.shape[-1]
    n_bytes = (2 * r.numel() * r.element_size() + v.numel() * v.element_size()
               + 4 * (r.numel() + H * dk + 2 * B * H * dk * dv
                      + B * T * H * dv))
    n_ops = B * T * H * (5 * dk * dv + 3 * dk + 2 * dv)
    return bound_ms(n_bytes, n_ops, FP32_OPS_PER_S)


def attention_pairs(Tq, Tk, causal, window, q_offset=0):
    """(row, key) pairs the masks keep: the work attention must do."""
    total = 0
    for i in range(Tq):
        pos = q_offset + i
        lo = max(0, pos - window + 1) if window > 0 else 0
        hi = min(Tk, pos + 1) if causal else Tk
        total += max(0, hi - lo)
    return total


def prefill_check(torch, gen, dt, case):
    """One flash attention case against the plain version, with its route.
    case: (label, B, Tq, Tk, H, Hkv, hd, hdv, causal, window, q_offset)."""
    from repro_torch.kernels.flash_attention import (
        attention_route, flash_attention_cuda, flash_attention_plain)
    label, B, Tq, Tk, H, Hkv, hd, hdv, causal, window, off = case
    name = _dtype_name(torch, dt)
    q = _randn(torch, gen, (B, Tq, H, hd), dt)
    k = _randn(torch, gen, (B, Tk, Hkv, hd), dt)
    v = _randn(torch, gen, (B, Tk, Hkv, hdv), dt)
    got = flash_attention_cuda(q, k, v, causal=causal, window=window,
                               q_offset=off)
    want = flash_attention_plain(q, k, v, causal=causal, window=window,
                                 q_offset=off)
    torch.cuda.synchronize()
    return {"kernel": "flash_attention", "case": label, "dtype": name,
            "route": attention_route(q, k, v),
            "shape": [B, Tq, Tk, H, Hkv, hd, hdv], "causal": causal,
            "window": window, "q_offset": off, "max_abs_err": _err(got, want),
            "ok": got.dtype == dt and _within(torch, got, want, TOL[name],
                                              TOL[name])}


def decode_check(torch, gen, dt, case):
    """One flash decode case against the plain version, with its route.
    case: (label, B, S, H, Hkv, hd, hdv, q dtype, lengths); the cache has
    type ``dt``."""
    from repro_torch.kernels.flash_attention import (
        decode_route, flash_decode_cuda, flash_decode_plain)
    label, B, S, H, Hkv, hd, hdv, qdt, lens = case
    name = _dtype_name(torch, dt)
    q = _randn(torch, gen, (B, H, hd), qdt)
    k = _randn(torch, gen, (B, S, Hkv, hd), dt)
    v = _randn(torch, gen, (B, S, Hkv, hdv), dt)
    cur = torch.tensor(lens, device="cuda")
    got = flash_decode_cuda(q, k, v, cur)
    want = flash_decode_plain(q, k, v, cur)
    torch.cuda.synchronize()
    tol = TOL[name]
    return {"kernel": "flash_decode", "case": label,
            "dtype": [_dtype_name(torch, qdt), name],
            "route": decode_route(q, k, v),
            "shape": [B, S, H, Hkv, hd, hdv], "lens": lens,
            "max_abs_err": _err(got, want),
            "ok": got.dtype == qdt and _within(torch, got, want, tol, tol)}


def phase_serve_kernels(torch):
    from repro_torch.kernels.rglru_scan import (linear_recurrence_plain,
                                                rglru_scan_cuda)
    from repro_torch.kernels.rwkv6_scan import wkv6_cuda, wkv6_plain

    gen = torch.Generator(device="cuda")
    gen.manual_seed(12)
    checks = []
    bf = torch.bfloat16
    for dt in (torch.float32, bf):
        # (label, B, Tq, Tk, H, Hkv, hd, hdv, causal, window, q_offset)
        for case in [
                ("recurrentgemma_prefill", 1, 2100, 2100, 10, 1, 256, 256,
                 True, 2048, 0),
                ("causal_no_window", 1, 700, 700, 10, 1, 256, 256, True, 0,
                 0),
                ("non_causal_ragged", 2, 130, 200, 4, 4, 64, 64, False, 0,
                 0),
                ("llama3_8b_gqa", 1, 1024, 1024, 32, 8, 128, 128, True, 0,
                 0),
                ("q_offset", 2, 64, 512, 4, 1, 128, 128, True, 0, 448)]:
            checks.append(prefill_check(torch, gen, dt, case))
        # (label, B, S, H, Hkv, hd, hdv, q dtype, lengths)
        for case in [
                ("recurrentgemma_decode", 4, 2048, 10, 1, 256, 256, dt,
                 [5, 2047, 2048, 5000]),
                ("fp32_query_cache_" + _dtype_name(torch, dt), 4, 2048, 10,
                 1, 256, 256, torch.float32, [1500, 2100, 17, 4095]),
                ("llama3_8b_gqa", 3, 512, 32, 8, 128, 128, dt,
                 [0, 300, 511])]:
            checks.append(decode_check(torch, gen, dt, case))
    # bf16 cases for every instance and edge of the tensor-core kernels:
    # head dims 32 to 256 (one to four V panels, hdv != hd), a prompt
    # shorter than one 64-key tile, GQA with B > 1, a window that cuts
    # tiles with q_offset, non-causal Tk < Tq
    for case in [
            ("hd64_window", 2, 300, 300, 8, 2, 64, 64, True, 100, 0),
            ("hd32", 1, 200, 200, 4, 1, 32, 32, True, 0, 0),
            ("hd80_hdv48", 1, 100, 100, 2, 1, 80, 48, True, 0, 0),
            ("hd128_hdv192", 1, 257, 257, 4, 2, 128, 192, True, 0, 0),
            ("short_prompt", 1, 40, 40, 10, 1, 256, 256, True, 0, 0),
            ("gqa32_8_batch2", 2, 300, 300, 32, 8, 128, 128, True, 0, 0),
            ("window_q_offset", 1, 200, 900, 10, 1, 256, 256, True, 256,
             700),
            ("non_causal_short_keys", 2, 200, 50, 4, 1, 128, 128, False, 0,
             0)]:
        checks.append(prefill_check(torch, gen, bf, case))
    # decode: lengths 0, S - 1, S and past S; groups of 1, 4, 10, 32 and
    # 64 heads (one, two and four 16-row tiles); an fp32 q on a bf16 cache
    # with a large group; hd 72 (the CUDA-core instance on a bf16 cache);
    # a batch large enough for one split
    for case in [
            ("lengths_0_S-1_S_past", 4, 2048, 10, 1, 256, 256, bf,
             [0, 2047, 2048, 5000]),
            ("mha_g1", 2, 512, 8, 8, 128, 128, bf, [100, 511]),
            ("gqa32_8", 4, 1024, 32, 8, 128, 128, bf, [0, 1023, 1024, 3000]),
            ("g32", 2, 300, 64, 2, 64, 64, bf, [0, 150]),
            ("g64", 2, 300, 64, 1, 128, 128, bf, [10, 299]),
            ("g64_fp32_query", 2, 300, 64, 1, 128, 128, torch.float32,
             [100, 299]),
            ("hd72", 2, 100, 6, 2, 72, 72, bf, [50, 99]),
            ("one_split", 64, 256, 32, 8, 128, 128, bf,
             list(range(0, 640, 10)))]:
        checks.append(decode_check(torch, gen, bf, case))
    for B, T, W in [(4, 1, 2560), (1, 2100, 2560), (2, 37, 100)]:
        a = torch.sigmoid(_randn(torch, gen, (B, T, W), torch.float32)) * 0.9
        b = _randn(torch, gen, (B, T, W), torch.float32)
        h0 = _randn(torch, gen, (B, W), torch.float32)
        h, hT = rglru_scan_cuda(a, b, h0)
        hp, hTp = linear_recurrence_plain(a, b, h0)
        torch.cuda.synchronize()
        checks.append({"kernel": "rglru_scan", "shape": [B, T, W],
                       "max_abs_err": max(_err(h, hp), _err(hT, hTp)),
                       "bit_equal": bool(torch.equal(h, hp)
                                         and torch.equal(hT, hTp)),
                       "ok": _within(torch, h, hp, RGLRU_ATOL, RGLRU_RTOL)
                       and _within(torch, hT, hTp, RGLRU_ATOL, RGLRU_RTOL)})
    # (label, B, T, H, dk, dv, r/k/v dtype, lowest decay)
    for label, B, T, H, dk, dv, dt, w_low in [
            ("rwkv6_decode", 4, 1, 64, 64, 64, torch.bfloat16, 0.9),
            ("rwkv6_prefill", 1, 2000, 64, 64, 64, torch.bfloat16, 0.9),
            ("rwkv6_prefill", 1, 2000, 64, 64, 64, torch.float32, 0.9),
            ("ragged", 2, 37, 3, 32, 48, torch.float32, 0.45),
            ("strong_decay", 1, 2000, 64, 64, 64, torch.float32, 1e-3)]:
        args = wkv6_inputs(torch, gen, B, T, H, dk, dv, dt, w_low)
        y, sT = wkv6_cuda(*args)
        yp, sTp = wkv6_plain(*args)
        state = args[5].clone()              # a serving slot's state
        y2, _ = wkv6_cuda(*args[:5], state, state_out=state)
        torch.cuda.synchronize()
        finite = bool(torch.isfinite(y).all() and torch.isfinite(sT).all())
        checks.append({"kernel": "wkv6", "case": label,
                       "dtype": _dtype_name(torch, dt),
                       "shape": [B, T, H, dk, dv], "lowest_decay": w_low,
                       "max_abs_err": max(_err(y, yp), _err(sT, sTp)),
                       "finite": finite,
                       "in_place_equal": bool(torch.equal(y2, y)
                                              and torch.equal(state, sT)),
                       "ok": finite and y.dtype == torch.float32
                       and _within(torch, y, yp, WKV_TOL, WKV_TOL)
                       and _within(torch, sT, sTp, WKV_TOL, WKV_TOL)
                       and bool(torch.equal(y2, y)
                                and torch.equal(state, sT))})
    ok = all(c["ok"] for c in checks)
    emit({"phase": "serve kernels", "ok": ok,
          "tolerance": {"float32": TOL["float32"], "bfloat16": TOL["bfloat16"],
                        "rglru_scan": [RGLRU_ATOL, RGLRU_RTOL],
                        "wkv6": [WKV_TOL, WKV_TOL]},
          "checks": checks})
    if not ok:
        raise PhaseFailed("a serving kernel disagrees with its plain version")


def phase_model_check(torch, np, arch):
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.models import backbone

    spec = SERVE_ARCHS[arch]
    cfg = dataclasses.replace(get_config(arch), n_layers=spec["check_layers"])
    n_prompt = spec["check_prompt"]
    gen = torch.Generator()                     # weights drawn on the host
    gen.manual_seed(spec["check_seed"])
    t0 = time.perf_counter()
    host = backbone.init_params(cfg, gen, dtype=torch.float32, device="cpu")
    card = _tree_map(lambda t: t.to("cuda"), host)
    init_s = time.perf_counter() - t0
    prompt = torch.as_tensor(np.random.default_rng(spec["check_seed"])
                             .integers(1, cfg.vocab, size=(1, n_prompt)))

    def run(params, device, feed=None):
        """Prefill, then decode the tokens of ``feed`` (when None, the run's
        own greedy picks).  Returns the logits of every step on the host,
        the tokens fed and the seconds taken."""
        caches = backbone.init_cache(cfg, 1, CHECK_CACHE,
                                     dtype=torch.float32, device=device)
        t = time.perf_counter()
        logits, caches = backbone.prefill(
            cfg, params, {"tokens": prompt.to(device)}, caches)
        out, fed = [logits.float().cpu()], []
        for i in range(CHECK_STEPS):
            tok = feed[i] if feed is not None else torch.argmax(out[-1], -1)
            fed.append(tok)
            logits, caches = backbone.decode_step(
                cfg, params, tok.to(device), caches, n_prompt + i)
            out.append(logits.float().cpu())
        return out, fed, time.perf_counter() - t

    host_logits, feed, host_s = run(host, "cpu")
    ops.reset_launches()
    card_logits, _, card_s = run(card, "cuda", feed)
    launches = {k: ops.launches[k] for k in spec["kernels"]}
    diffs = [float((c - h).abs().max())
             for c, h in zip(card_logits, host_logits)]
    within = all(bool(((c - h).abs() <= MODEL_TOL + MODEL_TOL * h.abs()).all())
                 for c, h in zip(card_logits, host_logits))
    agree = sum(int(torch.argmax(c)) == int(torch.argmax(h))
                for c, h in zip(card_logits, host_logits))
    finite = all(bool(torch.isfinite(c).all()) for c in card_logits)
    ok = within and finite and all(v > 0 for v in launches.values())
    emit({"phase": "model check", "ok": ok, "arch": arch,
          "layers": cfg.n_layers, "d_model": cfg.d_model, "dtype": "float32",
          "prompt": n_prompt, "decode_steps": CHECK_STEPS,
          "cache_len": CHECK_CACHE, "window": cfg.window,
          "tolerance": {"atol": MODEL_TOL, "rtol": MODEL_TOL},
          "max_abs_logit_diff": diffs, "greedy_agree": agree,
          "greedy_total": len(card_logits), "launches": launches,
          "init_s": init_s, "host_s": host_s, "card_s": card_s})
    if not ok:
        raise PhaseFailed("the card's logits disagree with the host's")
    del host, card


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_tree_map(fn, v) for v in tree]
    return fn(tree)


def _leaves(tree):
    out = []
    _tree_map(out.append, tree)
    return out


def phase_serve(torch, np, arch):
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.models import backbone
    from repro_torch.train.serve import BatchedServer, Request, ServeConfig

    class TimedServer(BatchedServer):
        """The server, with each prefill and decode step synchronised and
        timed, and its logits checked for finite values."""

        def __init__(self, *args, **kw):
            super().__init__(*args, **kw)
            self.prefill_s = self.decode_s = 0.0
            self.prefill_tokens = self.decode_steps = 0
            self.finite = True

        def _timed(self, fn, *args):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            logits, caches = fn(*args)
            self.finite &= bool(torch.isfinite(logits).all())
            return logits, caches, time.perf_counter() - t0

        def _prefill_impl(self, tokens, caches_slot, true_len):
            logits, caches, dt = self._timed(super()._prefill_impl, tokens,
                                             caches_slot, true_len)
            self.prefill_s += dt
            self.prefill_tokens += true_len
            return logits, caches

        def _decode_impl(self, tokens, caches, pos):
            logits, caches, dt = self._timed(super()._decode_impl, tokens,
                                             caches, pos)
            self.decode_s += dt
            self.decode_steps += 1
            return logits, caches

    spec = SERVE_ARCHS[arch]
    seed, max_new = spec["seed"], spec["max_new"]
    cfg = get_config(arch)
    torch.cuda.reset_peak_memory_stats()
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    t0 = time.perf_counter()
    params = backbone.init_params(cfg, gen, dtype=torch.bfloat16,
                                  device="cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    weight_bytes = sum(t.numel() * t.element_size() for t in _leaves(params))
    srv = TimedServer(cfg, params, ServeConfig(
        slots=SERVE_SLOTS, cache_len=SERVE_CACHE, seed=seed), device="cuda")
    rng = np.random.default_rng(seed)
    lens = rng.integers(1024, 2001, SERVE_REQUESTS)
    reqs = [Request(rid=i, prompt=rng.integers(1, cfg.vocab, size=int(n)),
                    max_new=max_new) for i, n in enumerate(lens)]
    for r in reqs:
        srv.submit(r)
    ops.reset_launches()
    t0 = time.perf_counter()
    steps = decode_tokens = 0
    while srv.queue or any(r is not None for r in srv.slot_req):
        decode_tokens += srv.step()
        steps += 1
        if steps > 10_000:
            raise PhaseFailed("the serve loop did not drain")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k: ops.launches[k] for k in spec["kernels"]}
    peak = torch.cuda.max_memory_allocated()
    last_pos = [len(r.prompt) + len(r.out) - 2 for r in reqs]
    # the ring must wrap where the arch has a window
    wrapped = sum(p >= cfg.window for p in last_pos) if cfg.window else None
    finished = all(r.done and len(r.out) == max_new for r in reqs)

    # The serve's last wave (its last SERVE_SLOTS requests: the served
    # prompts and lengths) replayed on a fresh server under the profiler,
    # for the card's busy share and kernel time by name; every other number
    # here comes from the untraced run above.
    tsrv = TimedServer(cfg, params, ServeConfig(
        slots=SERVE_SLOTS, cache_len=SERVE_CACHE, seed=seed), device="cuda")
    for r in reqs[-SERVE_SLOTS:]:
        tsrv.submit(Request(rid=r.rid, prompt=r.prompt, max_new=r.max_new))
    torch.cuda.synchronize()
    prof, trace_error = start_device_trace(torch)
    t1 = time.perf_counter()
    tsrv.run_until_drained()
    torch.cuda.synchronize()
    trace_wall = time.perf_counter() - t1
    trace = stop_device_trace(prof, trace_error, trace_wall)
    trace.update({"requests": [r.rid for r in reqs[-SERVE_SLOTS:]],
                  "wall_s": trace_wall, "prefill_s": tsrv.prefill_s,
                  "prefill_tokens": tsrv.prefill_tokens,
                  "decode_s": tsrv.decode_s,
                  "decode_steps": tsrv.decode_steps})
    del prof, tsrv
    # the eager dispatch of one decode step over the drained slots (the
    # untimed step of the plain server, so the timings above stay as run)
    step_ops = host_ops(torch, lambda: BatchedServer._decode_impl(
        srv, torch.zeros(SERVE_SLOTS, dtype=torch.int64, device="cuda"),
        srv.caches, torch.full((SERVE_SLOTS,), SERVE_CACHE // 2,
                               device="cuda")))
    ok = (finished and srv.finite and wrapped != 0
          and all(v > 0 for v in launches.values()))
    emit({"phase": "serve", "ok": ok, "arch": arch,
          "layers": cfg.n_layers, "params": sum(
              t.numel() for t in _leaves(params)),
          "param_count": cfg.param_count(),
          "dtype": "bfloat16", "cache_dtype": "bfloat16",
          "slots": SERVE_SLOTS, "cache_len": SERVE_CACHE,
          "requests": SERVE_REQUESTS, "max_new": max_new, "seed": seed,
          "prompt_lens": lens.tolist(), "requests_past_window": wrapped,
          "all_finished": finished, "logits_finite": srv.finite,
          "wall_s": wall, "steps": steps, "decode_tokens": decode_tokens,
          "prefill_tokens": srv.prefill_tokens, "prefill_s": srv.prefill_s,
          "prefill_tokens_per_s": srv.prefill_tokens / srv.prefill_s,
          "decode_steps": srv.decode_steps, "decode_s": srv.decode_s,
          "decode_tokens_per_s": decode_tokens / srv.decode_s,
          "ms_per_decode_step": srv.decode_s / srv.decode_steps * 1e3,
          "host_ops_per_decode_step": step_ops,
          "weight_read_bound_ms": weight_bytes / HBM_BYTES_PER_S * 1e3,
          "init_s": init_s, "weight_bytes": weight_bytes,
          "max_memory_allocated_bytes": peak, "launches": launches,
          "first_outputs": [r.out[:8] for r in reqs[:2]],
          "traced_window": trace})
    if not ok:
        raise PhaseFailed("a request did not finish, a logit was not "
                          "finite, no request wrapped the window, or a "
                          f"kernel of {arch} was not launched")
    del srv, params
    torch.cuda.empty_cache()
    return launches, lens


def attention_instances(functions, route, q, v_or_cache, G, decode,
                        hgmma=None):
    """The kernel functions that a served attention call ran, with their
    ptxas registers and spills (and HGMMA instructions, from ``hgmma``):
    the instance ``route`` names (template arguments as csrc/attention.cu
    picks them) and, for decode, the combine."""
    qt = "13__nv_bfloat16" if q.element_size() == 2 else "f"   # q's type
    if not decode:
        nvp = -(-v_or_cache.shape[-1] // 64)
        names = ([f"attn_wgmma_kernelILi{nvp}E"] if route == "wgmma" else [])
    else:
        mt = 1 if G <= 16 else 2 if G <= 32 else 4
        names = ([f"decode_mma_kernelI{qt}Li{mt}E"] if route == "mma"
                 else []) + [f"decode_combine_kernelI{qt}E"]
    found = [ptxas_of(functions, n) for n in names]
    for f in found:
        if hgmma is not None:
            f["hgmma"] = hgmma.get(f["function"], 0)
    return {"route": route, "functions": found}


def serve_kernel_entries(torch, np, launches, prompt_lens, functions,
                         hgmma):
    """The kernels line's entries of the serving kernels, each at the shape
    its path used most (bf16, as served): the median prompt for prefill
    attention, the four slots at mid-run positions for decode, and the
    decode step (B = 4, T = 1) for the RG-LRU scan, which launches it most;
    the scan's prefill shape is reported beside."""
    import torch.nn.functional as F

    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import (
        attention_route, decode_route, flash_attention_cuda,
        flash_attention_plain, flash_decode_cuda, flash_decode_plain)
    from repro_torch.kernels.rglru_scan import (linear_recurrence_plain,
                                                rglru_scan_cuda)

    cfg = get_config(RG)
    H, Hkv, hd, W, win = (cfg.n_heads, cfg.n_kv_heads, cfg.head_dim,
                          cfg.lru_width, cfg.window)
    bf = torch.bfloat16
    gen = torch.Generator(device="cuda")
    gen.manual_seed(11)
    entries = []

    # ---- flash attention: one prefill of the median prompt ----------------
    L = int(np.median(prompt_lens))
    q = _randn(torch, gen, (1, L, H, hd), bf)
    k = _randn(torch, gen, (1, L, Hkv, hd), bf)
    v = _randn(torch, gen, (1, L, Hkv, hd), bf)
    got = flash_attention_cuda(q, k, v, causal=True, window=win)
    want = flash_attention_plain(q, k, v, causal=True, window=win)
    pos = torch.arange(L, device="cuda")
    mask = (pos[None, :] <= pos[:, None]) & (pos[None, :] > pos[:, None] - win)
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))

    def sdpa():
        return F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask,
                                              enable_gqa=True)
    lib_out = sdpa().transpose(1, 2)
    pairs = attention_pairs(L, L, True, win)
    n_bytes = 2 * (2 * L * H * hd + 2 * L * Hkv * hd)
    n_ops = 4 * hd * H * pairs
    fa_bound, fa_by = bound_ms(n_bytes, n_ops, BF16_TC_OPS_PER_S)
    entries.append({
        "name": "flash_attention", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/attention.cu",
        "wrapper": "src/repro_torch/kernels/flash_attention.py",
        "replaces": "src/repro/kernels/flash_attention.py:78",
        "launches": launches["flash_attention"],
        "instance": attention_instances(functions, attention_route(q, k, v),
                                        q, v, H // Hkv, decode=False,
                                        hgmma=hgmma),
        "shape": [1, L, H, Hkv, hd], "dtype": "bfloat16", "window": win,
        "max_abs_err": _err(got, want),
        "library_max_abs_diff": _err(got, lib_out),
        "ms": device_ms(torch, lambda: flash_attention_cuda(
            q, k, v, causal=True, window=win), 20),
        "eager_ms": eager_ms(torch, lambda: flash_attention_cuda(
            q, k, v, causal=True, window=win), 20),
        "plain_ms": device_ms(torch, lambda: flash_attention_plain(
            q, k, v, causal=True, window=win), 2),
        "device_us_by_kernel": device_us_by_kernel(
            torch, lambda: flash_attention_cuda(q, k, v, causal=True,
                                                window=win), 20),
        "library": "F.scaled_dot_product_attention",
        "library_ms": device_ms(torch, sdpa, 20),
        "bound_ms": fa_bound, "bound_by": fa_by,
        "bound_rate": "bf16 tensor cores 989 TFLOP/s; HBM 3.35 TB/s",
        "bound_ms_fp32_cuda_cores": bound_ms(n_bytes, n_ops,
                                             FP32_OPS_PER_S)[0],
    })

    # ---- flash decode: the four slots at mid-run positions ----------------
    S = min(SERVE_CACHE, win)
    B = SERVE_SLOTS
    lens_list = [int(n) + SERVE_ARCHS[RG]["max_new"] // 2
                 for n in prompt_lens[:B]]
    lens = torch.tensor(lens_list, device="cuda")
    q = _randn(torch, gen, (B, H, hd), bf)
    kc = _randn(torch, gen, (B, S, Hkv, hd), bf)
    vc = _randn(torch, gen, (B, S, Hkv, hd), bf)
    got = flash_decode_cuda(q, kc, vc, lens)
    want = flash_decode_plain(q, kc, vc, lens)
    valid = [min(n + 1, S) for n in lens_list]
    dmask = (torch.arange(S, device="cuda")[None, :]
             < torch.tensor(valid, device="cuda")[:, None])[:, None, None, :]
    qd, kd, vd = q[:, :, None], kc.transpose(1, 2), vc.transpose(1, 2)

    def sdpa_decode():
        return F.scaled_dot_product_attention(qd, kd, vd, attn_mask=dmask,
                                              enable_gqa=True)
    lib_out = sdpa_decode()[:, :, 0]
    n_bytes = 2 * (2 * B * H * hd + sum(valid) * Hkv * 2 * hd)
    n_ops = 4 * hd * H * sum(valid)
    fd_bound, fd_by = bound_ms(n_bytes, n_ops, BF16_TC_OPS_PER_S)
    entries.append({
        "name": "flash_decode", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/attention.cu",
        "wrapper": "src/repro_torch/kernels/flash_attention.py",
        "replaces": "src/repro/kernels/flash_attention.py:162",
        "launches": launches["flash_decode"],
        "instance": attention_instances(functions, decode_route(q, kc, vc),
                                        q, vc, H // Hkv, decode=True),
        "shape": [B, S, H, Hkv, hd], "lens": lens_list, "dtype": "bfloat16",
        "max_abs_err": _err(got, want),
        "library_max_abs_diff": _err(got, lib_out),
        "ms": device_ms(torch, lambda: flash_decode_cuda(q, kc, vc, lens),
                        200),
        "eager_ms": eager_ms(torch, lambda: flash_decode_cuda(
            q, kc, vc, lens), 200),
        "plain_ms": device_ms(torch, lambda: flash_decode_plain(
            q, kc, vc, lens), 20),
        "device_us_by_kernel": device_us_by_kernel(
            torch, lambda: flash_decode_cuda(q, kc, vc, lens), 200),
        "library": "F.scaled_dot_product_attention",
        "library_ms": device_ms(torch, sdpa_decode, 200),
        "bound_ms": fd_bound, "bound_by": fd_by,
        "bound_rate": "HBM 3.35 TB/s; bf16 tensor cores 989 TFLOP/s",
    })

    # ---- RG-LRU scan: the decode step, and one prefill beside it ----------
    def scan_inputs(B, T):
        a = torch.sigmoid(_randn(torch, gen, (B, T, W), torch.float32)) * 0.9
        return (a, _randn(torch, gen, (B, T, W), torch.float32),
                _randn(torch, gen, (B, W), torch.float32))

    def scan_bound(B, T):
        return bound_ms(4 * (3 * B * T * W + 2 * B * W), 2 * B * T * W,
                        FP32_OPS_PER_S)

    a, b, h0 = scan_inputs(SERVE_SLOTS, 1)
    h, hT = rglru_scan_cuda(a, b, h0)
    hp, hTp = linear_recurrence_plain(a, b, h0)
    rg_bound, rg_by = scan_bound(SERVE_SLOTS, 1)
    pa, pb, ph0 = scan_inputs(1, L)
    ph, phT = rglru_scan_cuda(pa, pb, ph0)
    pph, pphT = linear_recurrence_plain(pa, pb, ph0)
    entries.append({
        "name": "rglru_scan", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/rglru.cu",
        "wrapper": "src/repro_torch/kernels/rglru_scan.py",
        "replaces": "src/repro/kernels/rglru_scan.py:63",
        "launches": launches["rglru_scan"],
        "shape": [SERVE_SLOTS, 1, W], "dtype": "float32",
        "max_abs_err": max(_err(h, hp), _err(hT, hTp), _err(ph, pph),
                           _err(phT, pphT)),
        "ms": device_ms(torch, lambda: rglru_scan_cuda(a, b, h0), 200),
        "eager_ms": eager_ms(torch, lambda: rglru_scan_cuda(a, b, h0), 200),
        "plain_ms": device_ms(torch, lambda: linear_recurrence_plain(
            a, b, h0), 200),
        "library": None, "library_ms": None,
        "bound_ms": rg_bound, "bound_by": rg_by,
        "prefill": {"shape": [1, L, W],
                    "ms": device_ms(torch, lambda: rglru_scan_cuda(
                        pa, pb, ph0), 20),
                    "plain_ms": device_ms(torch, lambda: (
                        linear_recurrence_plain(pa, pb, ph0)), 1),
                    "bound_ms": scan_bound(1, L)[0]},
    })
    tol = {"flash_attention": TOL["bfloat16"], "flash_decode": TOL["bfloat16"],
           "rglru_scan": RGLRU_ATOL}
    ok = all(e["launches"] > 0 and e["max_abs_err"] <= tol[e["name"]]
             for e in entries)
    return entries, ok


def wkv6_entry(torch, np, launches, prompt_lens):
    """The kernels line's entry of the WKV recurrence at the RWKV6-7B
    decode step (4 slots, T = 1, bf16 r/k/v), which launches it most, with
    the prefill of the median served prompt beside it."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.rwkv6_scan import wkv6_cuda, wkv6_plain

    cfg = get_config(RWKV)
    H, dk = cfg.n_heads, cfg.rwkv_head_dim
    gen = torch.Generator(device="cuda")
    gen.manual_seed(13)
    L = int(np.median(prompt_lens))
    dec = wkv6_inputs(torch, gen, SERVE_SLOTS, 1, H, dk, dk, torch.bfloat16,
                      0.9)
    pre = wkv6_inputs(torch, gen, 1, L, H, dk, dk, torch.bfloat16, 0.9)
    errs = []
    for args in (dec, pre):
        y, sT = wkv6_cuda(*args)
        yp, sTp = wkv6_plain(*args)
        errs += [_err(y, yp), _err(sT, sTp)]
    dec_bound, dec_by = wkv6_bound(dec[0], dec[2])
    pre_bound, pre_by = wkv6_bound(pre[0], pre[2])
    entry = {
        "name": "wkv6", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/wkv6.cu",
        "wrapper": "src/repro_torch/kernels/rwkv6_scan.py",
        "replaces": "src/repro/kernels/rwkv6_scan.py:77",
        "launches": launches["wkv6"],
        "shape": [SERVE_SLOTS, 1, H, dk, dk], "dtype": "bfloat16",
        "max_abs_err": max(errs),
        "ms": device_ms(torch, lambda: wkv6_cuda(*dec), 200),
        "eager_ms": eager_ms(torch, lambda: wkv6_cuda(*dec), 200),
        "plain_ms": device_ms(torch, lambda: wkv6_plain(*dec), 200),
        "library": None, "library_ms": None,
        "bound_ms": dec_bound, "bound_by": dec_by,
        "bound_rate": "HBM 3.35 TB/s; FP32 67 TFLOP/s, 5 flops a (row, "
                      "column) pair, 3 a row and 2 a column, a step",
        "prefill": {"shape": [1, L, H, dk, dk],
                    "ms": device_ms(torch, lambda: wkv6_cuda(*pre), 20),
                    "plain_ms": device_ms(torch, lambda: wkv6_plain(*pre),
                                          1),
                    "bound_ms": pre_bound, "bound_by": pre_by},
    }
    return entry, entry["launches"] > 0 and entry["max_abs_err"] <= WKV_TOL


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
    return kernels, ok


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
        smi_line, libraries, hgmma = phase_device(torch, cuda_lib)
        phase = "kernels"
        phase_kernels(torch, np)
        phase = "allocator"
        phase_allocator(torch, np)
        phase = "slice"
        launches, stats = phase_slice(torch, np)
        phase = "serve kernels"
        phase_serve_kernels(torch)
        for arch in SERVE_ARCHS:
            phase = f"model check {arch}"
            phase_model_check(torch, np, arch)
        served = {}
        for arch in SERVE_ARCHS:
            phase = f"serve {arch}"
            served[arch] = phase_serve(torch, np, arch)
        phase = "kernels line"
        alloc_entries, alloc_ok = phase_kernel_line(torch, np, launches,
                                                    stats)
        serve_entries, serve_ok = serve_kernel_entries(
            torch, np, *served[RG], libraries["attention"]["ptxas"], hgmma)
        wkv, wkv_ok = wkv6_entry(torch, np, *served[RWKV])
        line = {"kernels": alloc_entries + serve_entries + [wkv]}
        ok = alloc_ok and serve_ok and wkv_ok
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
