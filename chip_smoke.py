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
               the card, bit for bit, and against numpy: the matvec
               against a numpy loop (rows ragged against its row group, W
               odd, 0 and 512); the OPT=MIN solve in its yields and in
               each lane's rounds, and against ``maxmin_yields_csr`` lane
               by lane, on both routes, with lanes that have nothing
               active, lanes capped at 1 and lanes whose second round
               binds on near-ties (most must bind on a near-tie that is
               not exact); the node-usage scatter against its plain
               version and in-order np.add.at at the stretch passes' paper
               shapes (16 lanes, 128 nodes, up to 128 x 32 entries) and
               ragged ones (against a CTA's 8 nodes, a warp's 32 entries
               and a tile's 2,048), with padding sentinels, entries outside
               the nodes and negative ids, an empty lane, no entries, one
               lane, a lane whose every entry names one node and a node
               whose sum depends on the order of its adds;
3. allocator — the batched OPT=MIN water-filling and the OPT=AVG floor on
               the card against the numpy kernels, 200 seeded random
               incidences each, bit for bit;
4. slice     — ``run_batched`` over paper-size cells (Lublin, 1000 jobs,
               128 nodes, load 0.7: OPT=MIN seeds, two OPT=AVG cells, two
               EASY cells) on the card; every outcome field of every record
               must equal the host numpy ``Engine`` run of the same cell
               (timed, with its allocation share; see "host checks" and
               "parts" below);
               the kernel launch counts (and the solve's routes) are
               zeroed just before and read just after; ``torch.profiler`` traces the card's activity over the
               run for the device's busy share; peak device memory is
               counted from the allocation at the phase's start;
4b. slice mcb8 — ``run_batched`` over the paper's MCB8 policy family on
               the card: Lublin (1000 jobs, 128 nodes, load 0.7, seed 0)
               under the /per, MCB8 *, /stretch-per (OPT=MAX and OPT=AVG)
               and MINFT policies, and HPC2N (1000 jobs, 128 nodes, seed
               0) under EASY and GreedyPM */per/OPT=MIN/MINVT=600; every
               outcome field of every record must equal the host numpy
               ``Engine`` run (timed by cell, in the host checks), both
               kernels must launch,
               and the launch counts, busy share and peak memory are read
               as in phase 4;
4c. slice session — open sessions on the card, under GreedyP */OPT=MIN:
               (a) a 20,000-job synthetic swf log (the scale benchmark's
               recipe, offered load ~0.7 on 128 nodes) streamed through
               ``stream_trace`` in 4-day windows into ``open_session``
               with rows compacted every 4,096 retired, against the host
               numpy ``Engine`` run of the whole log, uncompacted, every
               ``SimResult`` field with the per-job dicts; peak engine
               rows; (b) phase 4's Lublin trace (seed 0) stepped to its
               500th release, a failure of nodes 0-7 at +600 s and their
               join at +7,200 s injected, the snapshot saved and loaded,
               9 what-if branches raced in lockstep by ``run_branches``
               on the card, each record against its host run, the
               same-policy branch also against the original session run
               on; launch counts zeroed before and read after each part;
               the host runs of (a) and of each branch alone go to the
               host checks below; (c) a line of its own: (a)'s log as a
               ``Trace`` saved as npz and JSON and loaded back (equal
               fingerprints and total work), and ``maxmin_yields_torch``
               (the one-lane MIN solve) on the card against the host
               ``maxmin_yields_csr`` on 4 incidences of phase 4's Lublin
               trace, bit for bit, outside every counted window;
4d. slice scenarios — scenario grids, chaos and the autotuner on the card,
               at phase 4's size, under GreedyP */OPT=MIN unless said:
               (a) ``run_grid`` on the card over 14 cells — Lublin (phase
               4's seed 0) under GreedyP */OPT=MIN and GreedyPM
               */per/OPT=MIN/MINVT=600 crossed with rack_failure,
               rolling_failures, elastic, arrival_burst+mem_pressure and
               ptime_noise; EASY x rack_failure; Greedy */OPT=AVG x
               rolling_failures; the tpu job mix (1000 x 128, load 0.6,
               seed 0) under GreedyPM */per/OPT=MIN/MINVT=600 and EASY —
               every record (Theorem-1 bound and degradation included)
               against the supervised host pool (4 workers, 600 s budget,
               1 retry, none quarantined); then ``api.sweep`` over the same
               grid with a record cache, twice: the first pass simulates
               every cell on the card, the second none (equal records,
               no launch); (b) a session under the chaos narrator
               (breakdown, cancel, malleable and noise streams, seed 7) on
               phase 4's Lublin trace, stepped to its 500th release,
               saved, loaded and restored on the card, against the
               uninterrupted card run and the host numpy run in every
               ``SimResult`` field with the per-job dicts; the injections
               by kind; (c) the autotuner racing in lockstep on the card:
               the reference's demo (Lublin 150 x 32, seed 7, load 1.1,
               nodes 0-7 fail at 2,050 s and join at 7,000 s; one swap at
               6,000 s, max stretch 301.598467), then a paper-size tuned
               session under (b)'s breakdown and noise streams, run to
               80,000 s (a reference-side livelock keeps it from ending),
               each against the host numpy tuner (decisions and result); the
               races, rungs and walls; launch counts, shapes, busy share
               and peak memory by part as in phase 4; (b)'s and (c)'s host
               runs go to the host checks;
   host checks — each phase's host reference runs (phase 4's 20 cells,
               4b's 10, 4c's whole log and 9 branches, 4d's chaos session
               and two tuned sessions) in a pool of processes at nice 10,
               one a job up to one a core, the longest first, once the
               phase's card runs have ended; then the phase's check and
               line;
   parts     — phases 4 and 4e (4e takes phase 4's seed-0 pair as its
               yardstick), 4b, 4c, 4d (a), 4d (b)-(c) and 10 (a) are
               driven by the host, the card idle through most of them:
               each runs in a process of its own (``chip_smoke.py --part
               <name>``), all six started together once phase 3 has
               ended, so their walls overlap one another (never a phase
               of 5-10's); a seventh, at nice 19, runs phase 9 (a)'s
               checks of the MoE, MLA / MTP, encoder-decoder and vision
               families on the cores and the card's memory the others
               leave free; the script prints each part's lines, in phase
               order, once it has ended, then 4d's line, and fails if any
               part failed;
4e. slice serve — the multi-tenant session server, every session on the
               card, 128 nodes: (a) a ``ServerThread`` (store, 64 live,
               no fsync) and 4 tenants, each a client in its own thread,
               each opening 128 sessions (GreedyP */OPT=MIN; the first
               of each tenant Greedy */OPT=AVG), submitting Lublin (100
               jobs, load 0.7, the session's index as the seed) and
               stepping it to 1,800 s; 2 sessions a tenant then ``run``
               and ``result`` through the server, each against the host
               numpy session of the same ops in every ``SimResult``
               field, at least one rehydrated from the store by its
               ``run``; any error response fails; sessions held, live at
               peak, evictions, rehydrations, ops/s, the p50/p99 of each
               op, launches and the commonest MIN shapes, the busy share,
               device memory in use and at peak with 64 sessions held and
               with 512 (it must not grow with them); (b) ``python -m
               repro_torch serve`` (on the card) and ``client`` processes
               drive phase 4's seed-0 trace to 20,000 s, the server is
               killed with SIGKILL, restarted on its store, and the script
               re-driven with ``run`` and ``result``: the first three ops
               must come back as duplicates and the result must equal
               phase 4's host run; (c) ``python -m repro_torch simulate``
               of phase 4's seed-0 cell must equal its record and host
               run, and ``python -m repro_torch tune`` of the
               BENCH_tune.json demo must swap once at 6,000 s and end at
               301.598467;
5. serve kernels — flash attention, flash decode, the RG-LRU scan and the
               RWKV6 WKV recurrence against their plain versions on the
               card, fp32 and bf16, at RecurrentGemma-2B's shapes (a prompt
               of 2,100 tokens under the 2,048 window), without a window,
               non-causal, at Llama-3-8B's GQA widths and SmolLM-360M's
               group of 3 at head dim 64, per-request decode
               lengths past the cache, T = 1 and a long T; bf16 cases
               that reach every attention instance and edge (hd 32 to
               256, hdv != hd, a prompt shorter than a key tile, GQA with
               B > 1, decode lengths 0, S - 1, S and past S, groups of 1,
               4, 10, 32 and 64 heads), each with its route; the RG-LRU
               scan on both routes (both sides of the threshold, T short
               of a chunk and ragged against it; the sequential route bit
               for bit, the chunked one bit for bit against its own plain
               algorithm); its gated route (the layer's gate chain fused
               into the recurrence, bf16 and fp32, a decode step of 4 x
               2,560, T one short of the threshold, a ragged width, T = 0,
               hT written over h0, and the gradients of a differentiable
               call) against the chain run operator by operator, bit
               equality reported; and at RWKV6-7B's (a decode step of 4
               slots, a
               prefill of 2,000 tokens on both routes, fp32 and bf16, both
               sides of the threshold, a ragged dk != dv, T short of a
               chunk and ragged against it and its sub-chunks, decays down
               to 1e-3 and to 1e-6 over 2,000 steps, the state written in
               place on each route); and at the MoE family's shapes, fp32
               and bf16, each timed beside SDPA (its backend named):
               DeepSeek-V3's MLA prefill (1,024 tokens, 128 heads, qk head
               dim 192 over v head dim 128, scale 1/sqrt(192): wgmma<2>),
               Qwen1.5-MoE's prefill (1,540 tokens, 16 over 16 heads of
               128: wgmma<2>) and decode (4 x 4,096 slots, a group of one:
               mma<1>, lengths 0, S - 1 and past S); and at Whisper's
               (20 over 20 heads of 64) and InternVL2's (64 over 8 of
               128), fp32 and bf16, each timed beside SDPA: the encoder's
               1,500 frames (bidirectional: wgmma<1>), a 384-token decoder
               prompt, cross-attention prefill (300 queries against 1,500
               frames, non-causal, both ragged against a key tile),
               decode over 512 slots and over the 1,500 cross frames
               (cur_len = S_enc), InternVL2's prefill (1,500 tokens:
               wgmma<2>) and decode (a group of 8 over 4,096 slots:
               mma<1>); a decode over an empty cache (S = 0, the mirrored
               server's cross cache) must give exactly 0; every fp32
               prefill case on the 3xTF32 instance (route ``tf32x3``, its
               largest difference within 2e-5) but an fp32 q over bf16 k
               and v and fp32 at head dim 60, which keep the CUDA-core
               one; rows the masks leave with no key (q_offset < 0)
               attend to every key with equal weight, as in the
               reference, on all three prefill instances (fp32 2e-5, bf16 2e-2,
               the RG-LRU atol 1e-5 / rtol 1e-4, the WKV atol = rtol =
               1e-4: the reference's kernel tolerances);
6. model check — per arch at full width, cut in depth, fp32, seeded
               weights drawn on the card and copied to the host:
               RecurrentGemma-2B one super-block deep (RG-LRU, RG-LRU,
               local attention), prefill of 2,100 tokens; RWKV6-7B 2
               layers deep, prefill of 1,000 tokens; the dense decoders
               2 layers deep, prefill of 512 tokens: Llama-3-8B (once with
               an fp32 cache, once with the int8 KV layout on both sides),
               Qwen3-8B (qk_norm), SmolLM-360M (15 query heads over 5, head
               dim 64, tied embeddings) and Granite-3-2B (tied embeddings,
               a 49,155 vocabulary); the MoE family 2 layers deep, prefill
               of 512 tokens: Qwen1.5-MoE-A2.7B (60 experts top-4, 4
               gated shared ones) and DeepSeek-V3 (both layers MLA with
               the dense MLP, its MTP depth left out); Whisper-large-v3 2
               encoder and 2 decoder layers deep, 1,500 seeded frames
               encoded into a filled cross cache, prefill of 256 tokens;
               InternVL2-76B 2 layers deep, 256 seeded patch embeddings in
               place of the first of 512 tokens; then 8 decode steps
               (DeepSeek-V3's through the absorbed latent decode), on the
               card (kernels) and on the host CPU (plain versions), logits
               compared (atol = rtol = 2e-3) and greedy tokens counted;
               where the cut has MoE layers, both sides' top-k experts per
               token and layer are recorded and compared: the flips at the
               first call with any must be near-ties (the host's k-th and
               (k+1)-th router probabilities within 1e-6), and the logits
               must agree at every step before it (the count of flips,
               their layers and the smallest host margin are reported);
7. serve     — per arch at full width (bf16 weights and cache) through
               ``BatchedServer``, 4 slots, cache 4096, 8 requests of
               1,024-2,000 prompt tokens, cut in depth for the script's
               time limit: RecurrentGemma-2B (13 of its 26 layers) with 96
               new tokens each, so that decode wraps the 2,048 ring;
               RWKV6-7B (16 of 32 layers) with 64; Llama-3-8B (16 of 32
               layers, 32 query heads over 8, head dim 128) with 64;
               Qwen1.5-MoE-A2.7B at full depth (24 layers, 60 routed
               experts top-4 and 4
               gated shared ones, 16 heads over 16), one wave of 4
               requests of 64 new tokens; DeepSeek-V3 cut to 4 layers (the
               3 dense MLA layers and one MoE layer of 256 experts top-8
               and a shared one; no MTP depth), one wave of 4 requests of
               16 new tokens (both cut in requests for the script's time
               limit); Whisper-large-v3 at full size (32 encoder and 32
               decoder layers), cache 512, 8 requests of 64-384 prompt
               tokens and 64 new ones, each with 1,500 seeded frames
               (30 s of audio) encoded and its cross K/V cached at
               admission (as a user runs it, not as the reference's
               server, which encodes 8 zero frames into an empty cross
               cache), with the encoder's frames a second against its
               operation bound and a step against the read of the
               decoder's weights and the cross K/V, then ``python -m
               repro_torch.launch.serve --arch whisper-large-v3``
               (the mirrored server) as a process, which must exit 0;
               InternVL2-76B at full width cut to 8 of its 80 layers, one
               wave of 4 requests of 1,024-2,000 tokens whose first 256
               take seeded patch embeddings, 32 new tokens each; each MoE
               serve also gives
               the weight bytes a decode step reads (every expert, as the
               dispatch multiplies all E experts' buffers) and a token's
               active bytes, each over 3.35 TB/s; every request
               must finish with finite logits, and the launch counts and
               instances, zeroed just before and read just after, must
               show every kernel of the arch, each launch on its instance:
               prefill attention on ``attn_wgmma_kernel<NVP>`` (NVP 4 for
               RecurrentGemma-2B's head dim 256, 2 for Llama-3-8B's,
               Qwen1.5-MoE's, MLA's and InternVL2's v head dim of 128, 1
               for Whisper's 64: its encoder, decoder and cross-attention
               prefill), decode attention on ``decode_mma_kernel<TQ, 1>``
               (Whisper's cross-attention decode too), every
               prefill launch of the RG-LRU scan and of the WKV recurrence
               on the chunked route and every decode launch on the
               sequential one (the RG-LRU's on its gated route); then the
               serve's last wave
               (its last 4 requests, the served prompts, at most 16 new
               tokens each) is replayed on a fresh server under
               ``torch.profiler`` for the card's busy share and kernel time
               by name;
8. kernels line — per kernel: launches on its path (phase 4 or 7; the
               allocation kernels' also by part of phases 4c, 4d and 4e;
               the node-usage kernel, which no path calls, on 4e's), the
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
               their device time by kernel name, at RecurrentGemma-2B's
               served shapes and, under ``llama3_8b``,
               ``qwen2_moe_a2_7b``, ``deepseek_v3_671b`` (prefill
               only), ``whisper_large_v3`` (with its encoder's and
               cross-attention's shapes beside) and ``internvl2_76b``, at
               those archs' (their launches and instances beside
               them, SDPA's backend named); the RG-LRU scan
               and the
               WKV recurrence have an entry per route (decode on the
               sequential route, the median served prompt on the chunked
               one, with the sequential route's time at that shape
               beside it; the RG-LRU's decode step also on its gated
               route, which the serve takes, so its sequential route is
               off the path and timed beside ``torch.addcmul``), with the
               ptxas registers and spills of the route's kernel
               functions; beside each model kernel, its
               launches on the training path (phase 9), attention's
               also timed in fp32 at each shape the checks of the MoE,
               MLA / MTP, encoder-decoder and vision families launched it
               in (a), against its plain version and SDPA, with the
               ``cuda_cores`` instance that took fp32 before the
               ``tf32x3`` one forced on the same inputs, the registers
               and spills of both, and a second bound, the three TF32
               products of 3xTF32 at 495 TFLOP/s, beside the FP32 one;
9. train     — the training path, fp32, AdamW unless said: (b) ``python -m repro_torch.launch.train``
               as a process at SmolLM-360M's full size (32 layers, d_model
               960, 15 query heads over 5 of 64, vocab 49,152, tied),
               batch 4 x 1,024 tokens, 12 steps, a checkpoint every 4,
               alone: ms a step, tokens/s, peak device memory, attention
               launches a step (forward and remat recompute: 2 a layer,
               all on the ``tf32x3`` route), the least time a step could take
               (FP32 67 TFLOP/s); one step of the same size traced in this
               process for the busy share and the port's kernels' share;
               then the same run with failures injected at steps 6 and 9
               (in the background while (a) runs), which must restart
               twice, from steps 4 and 8, and end within rel 1e-5 of the
               clean run's final loss (the gap is reported); (a) full
               width, cut in depth, weights drawn on the card and copied
               to the host, the same tokens on both sides, a few steps on
               the card (kernels forward, autograd of the plain versions
               backward) and on the host (plain versions): SmolLM-360M 2
               layers at 2 x 512 tokens, 3 steps (learning rate 0, then
               1e-3), under AdamW, Adafactor with 2 microbatches and AdamW
               with int8 compression; RecurrentGemma-2B one super-block at
               1 x 256 (the RG-LRU scan on its chunked route) and RWKV6-7B
               one layer at 1 x 256 (the WKV recurrence on its chunked
               route), one step each at 1e-3; then, in a part of their
               own (see "parts"), the families the CPU tests alone
               trained before: Qwen1.5-MoE-A2.7B's 2 of 24 layers (both
               MoE: 60 routed experts top-4, 4 gated shared) at 2 x 256,
               one step; DeepSeek-V3's first layer (MLA over a dense MLP)
               and its MTP depth at 1 x 256, one Adafactor step;
               Whisper-large-v3's 2 + 2 of 32 + 32 layers at 1 x 448 over
               1,500 frames, 2 steps with int8 compression;
               InternVL2-76B's first of 80 layers at 1 x 512 (256
               patches), one Adafactor step; every step's loss, grad
               norm, MoE auxiliary loss and MTP loss within rel 1e-4,
               every leaf of the final state (parameters, moments, error
               feedback) within atol = rtol = 2e-3, Adafactor's bf16 first
               moment and a compressed run's leaves within a budget (up to
               max(2, 0.5 %) of a leaf's elements outside, all within
               0.05), and every kernel launch counted on its instance
               (attention's also by shape) and equal to the count the
               config implies (``train_launches``); the MoE routing
               recorded on both sides, a flip passing only on a near-tie
               of the host (the leaves it moved named); each check's
               host and card seconds and peak host and card memory.

10. dry run  — (a) ``python -m repro_torch.launch.dryrun`` (its ``main``)
               over every shape and both meshes, one job an arch in a
               host pool, a part of its own (see "parts"): all 80
               (arch x shape x mesh) records ``ok``, or ``skipped``
               exactly where ``shape_applicable`` says; each cell's
               bottleneck, three roofline terms and GiB a device, and each
               job's seconds; (b) the single-mesh records through
               ``launch.roofline.jobgen_records`` into the ``tpu`` kind
               (200 jobs, 128 nodes, load 0.7, seed 0) under GreedyP
               */OPT=MIN, ``run_batched`` on the card against the host
               numpy ``Engine``, every outcome field equal; the job types'
               ``cpu_need`` and ``mem_req``; (c) on a one-device plan (a
               (1, 1) mesh), the dry run of the very steps phases 7 and 9
               timed — the decode steps of RecurrentGemma-2B, RWKV6-7B and
               Llama-3-8B (half depth), Qwen1.5-MoE-A2.7B, Whisper-large-v3
               and InternVL2-76B (8 layers), 4 slots, bf16 at 989 TFLOP/s;
               SmolLM-360M's train step, 4 x 1,024, fp32 at 67 TFLOP/s,
               AdamW — each measured step over its dry-run bound (it fails
               below 0.95), the measured peak device memory over the dry
               run's bytes a device (it fails outside 0.5-2), the dry run's
               memory term beside the hand-worked weight read (and phase
               9's hand-worked bound).

Then the nvidia-smi line again, the kernels line, and last
``{"ok": true, "device": {...}}``.  Without a CUDA device, or without the
port beside this script, it exits non-zero and prints no result.
"""
from __future__ import annotations

import dataclasses
import gc
import json
import os
import subprocess
import sys
import time
import traceback
from collections import Counter
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# NVIDIA H100 SXM data sheet: HBM3 bandwidth, FP64 and FP32 (non-tensor)
# peaks, bf16 and TF32 dense tensor-core peaks
HBM_BYTES_PER_S = 3.35e12
FP64_OPS_PER_S = 34e12
FP32_OPS_PER_S = 67e12
BF16_TC_OPS_PER_S = 989e12
TF32_TC_OPS_PER_S = 495e12

N_JOBS, N_NODES, LOAD = 1000, 128, 0.7
MIN_SEEDS = 16          # GreedyP */OPT=MIN cells in phase 4 (slice)
# phase 4b (slice mcb8): the MCB8 family on Lublin seed 0 (phase 4's trace
# size), and the paper's headline pair on its HPC2N trace set (seed 0)
MCB8_LUBLIN = ("GreedyP */per/OPT=MIN/MINVT=600",
               "GreedyPM */per/OPT=MIN/MINVT=600",
               "MCB8 */OPT=MIN/MINVT=600", "MCB8/per/OPT=MIN/MINVT=600",
               "/per/OPT=MIN", "/stretch-per/OPT=MAX", "/stretch-per/OPT=AVG",
               "GreedyPM */per/OPT=AVG/MINFT=300")
MCB8_HPC2N = ("EASY", "GreedyPM */per/OPT=MIN/MINVT=600")
HPC2N_JOBS = 1000       # not cut
# phase 4c (slice session): a 20,000-job swf log (the scale benchmark's
# synthetic recipe, mean gap cut to 280 s for an offered load near 0.7 on
# 128 nodes) streamed in 4-day windows through a compacting session; and 9
# what-if branches forked from phase 4's Lublin trace at its 500th release
SESSION_POLICY = "GreedyP */OPT=MIN"
STREAM_JOBS, STREAM_GAP_S = 20_000, 280.0
STREAM_WINDOW_S, COMPACT_AT = 4 * 86_400.0, 4096
BRANCH_AT, FAIL_NODES = 500, tuple(range(8))
#: (c): the host engine's allocation calls on phase 4's Lublin trace whose
#: incidences the one-lane solve takes (every 200th, 4 of them)
SURFACE_EVERY, SURFACE_INCIDENCES = 200, 4
BRANCHES = ("GreedyP */OPT=MIN", "GreedyPM */OPT=MIN", "Greedy */OPT=AVG",
            "GreedyPM */per/OPT=MIN/MINVT=600",
            {"policy": "GreedyPM */per/OPT=MIN/MINVT=600", "period": 1200.0},
            "MCB8 */OPT=MIN/MINVT=600", "EASY+OPT=MIN", "EASY", "FCFS")

# phase 4d (slice scenarios): (a) a 14-cell scenario grid on phase 4's
# Lublin trace (seed 0) and on the tpu job mix (1000 x 128, its default
# load 0.6, seed 0); the host run is the supervised pool of 4 workers
SCEN_POLICIES = ("GreedyP */OPT=MIN", "GreedyPM */per/OPT=MIN/MINVT=600")
SCEN_CHAINS = ("rack_failure", "rolling_failures", "elastic",
               "arrival_burst+mem_pressure", "ptime_noise")
TPU_POLICIES = ("GreedyPM */per/OPT=MIN/MINVT=600", "EASY")
SCEN_WORKERS = 4
# (b) chaos on phase 4's Lublin trace: ~25 breakdowns over its ~52,000 s
CHAOS = ("breakdown(mtbf=2e3,repair=8e2)+cancel(rate=1e-4)"
         "+malleable(rate=1e-4)+noise(sigma=0.3)")
NARRATOR_SEED = 7
# (c) the autotuner: the reference's demo (benchmarks/tune_bench.py,
# BENCH_tune.json), then a paper-size tuned session under (b)'s breakdown
# and noise streams
TUNE_JOBS, TUNE_NODES, TUNE_SEED, TUNE_LOAD = 150, 32, 7, 1.1
TUNE_RACK, TUNE_FAIL_T, TUNE_JOIN_T = tuple(range(8)), 2050.0, 7000.0
TUNE_PORTFOLIO = ("GreedyP */OPT=MIN", "GreedyPM */per/OPT=MIN/MINVT=600")
TUNE_INCUMBENT = TUNE_PORTFOLIO[0]
TUNE_SPEC = ("every=1500;horizon=4000;rungs=2;margin=0.01;dwell=0;"
             "policies=" + "|".join(TUNE_PORTFOLIO))
TUNE_DEMO_STRETCH = 301.598467      # BENCH_tune.json, one swap at 6,000 s
TUNER_SEED = 3
CHAOS_TUNED = "breakdown(mtbf=2e3,repair=8e2)+noise(sigma=0.3)"
TUNE_PAPER_SPEC = ("every=5000;horizon=4000;rungs=2;margin=0.01;dwell=0;"
                   "policies=GreedyP */OPT=MIN|GreedyPM */OPT=MIN|"
                   "GreedyPM */per/OPT=MIN/MINVT=600")
# the tuned session runs to this sim time, not to exhaustion: under
# GreedyPM */OPT=MIN, full-width jobs paused by a breakdown are not placed
# again when their nodes rejoin, and the breakdown stream keeps the loop
# armed for ever (in both packages; ROADMAP.md section 3).  (b)'s chaos run
# ends near 67,400 s.
TUNE_PAPER_UNTIL_S = 80_000.0

_NEED_EPS, _TIE_TOL, _CAP_TOL = 1e-12, 1e-15, 1e-12   # as in the solve
HOST_NICE = 10          # the host reference pools' workers

# the port's kernels, by the names the profiler gives them
_PORT_KERNELS = ("alloc_matvec_kernel", "maxmin_solve_kernel", "attn_kernel",
                 "attn_wgmma_kernel", "attn_tf32x3_kernel", "decode_kernel",
                 "decode_mma_kernel",
                 "decode_combine_kernel", "rglru_scan_kernel",
                 "rglru_gated_kernel",
                 "rglru_chunk_summary_kernel", "rglru_chunk_out_kernel",
                 "wkv6_kernel", "wkv6_chunk_state_kernel",
                 "wkv6_chunk_prefix_kernel", "wkv6_chunk_out_kernel")

_OUTCOMES = ("max_stretch", "mean_stretch", "makespan", "underutilization",
             "n_pmtn", "n_mig", "pmtn_per_job", "mig_per_job",
             "pmtn_per_hour", "mig_per_hour", "bytes_moved_gb",
             "bandwidth_gbps", "events", "hit_max_events", "final_time")


_START = time.perf_counter()


def emit(obj) -> None:
    """One JSON line; a phase's line also says when in the script it was
    printed (``at_s``, seconds from the script's start)."""
    if "phase" in obj:
        obj = {**obj, "at_s": time.perf_counter() - _START}
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


def solve_inputs(rng, B, N, W):
    """Inputs of the OPT=MIN solve, (present, weight, active) of B lanes,
    most of whose second round binds on a cluster of near-ties, and each
    lane's pilot node (-1 where the lane has none).

    Such a lane has a pilot node with weight 1 on four pilot columns, so
    round 1 binds it alone at level 1/4 and freezes those columns.  A
    quarter of the other nodes are planted: each holds one pilot column
    with weight 4 (1 - t) and one private column with weight 1, so from
    round 2 on its frozen use is 1 - t and its need 1: its level sits at
    the lane's base t in [0.3, 0.45] plus a multiple of 0.3e-15 up to
    3e-15 either way (exact ties, levels within the 1e-15 scan tolerance
    and levels just beyond it, in random node order).  The remaining
    nodes hold one column of their own set with need in [1.6, 2] (levels
    above all planted ones) or nothing.  Every sixth lane is a random
    incidence, every seventh has no active column, and every eighth
    needs at most 1 a node, so its level caps at 1.  Where the shape is
    too small for the structure, a lane is a random incidence."""
    import numpy as np
    present = np.zeros((B, N, W), dtype=bool)
    weight = np.zeros((B, N, W))
    active = np.zeros((B, W), dtype=bool)
    pilots = np.full(B, -1)
    for b in range(B):
        p, w = present[b], weight[b]
        if b % 7 == 6:
            continue                                   # nothing active
        if b % 8 == 7:                                 # capped at 1
            for n in range(N):
                cols = rng.choice(W, min(W, int(rng.integers(0, 3))),
                                  replace=False)
                p[n, cols], w[n, cols] = True, 0.5
        elif b % 6 == 5 or N < 8 or W < 12:            # random incidence
            w[:] = incidence_batch(rng, 1, N, W)[0]
            p[:] = w > 0
            p |= (rng.random((N, W)) < 0.05) & ~p      # zero-need entries
        else:
            cols = rng.permutation(W)
            pilot, rest = cols[:4], cols[4:]
            private, own = rest[: len(rest) // 2], rest[len(rest) // 2:]
            nodes = rng.permutation(N)
            pilots[b] = nodes[0]
            p[nodes[0], pilot], w[nodes[0], pilot] = True, 1.0
            base = rng.uniform(0.3, 0.45)
            for k, n in enumerate(nodes[1:]):
                if k < (N - 1) // 4:                   # planted
                    t = base + int(rng.integers(-10, 11)) * 0.3e-15
                    j, jp = rng.choice(pilot), rng.choice(private)
                    p[n, j], w[n, j] = True, 4.0 * (1.0 - t)
                    p[n, jp], w[n, jp] = True, 1.0
                elif rng.random() < 0.8:
                    j = rng.choice(own)
                    p[n, j], w[n, j] = True, rng.uniform(1.6, 2.0)
        used = p.any(axis=0)
        active[b] = used | (rng.random(W) < 0.5)
        p[:, ~active[b]], w[:, ~active[b]] = False, 0.0
    return present, weight, active, pilots


def second_round(present, weight, active, pilots):
    """f_use and u_need of round 2 of the solve (numpy, sequential
    matvecs) of the lanes of :func:`solve_inputs`, whose round 1 binds the
    pilot node alone: its columns frozen at 1/4."""
    import numpy as np
    B, N, W = weight.shape
    frozen = ~active
    y = np.zeros((B, W))
    for b in np.nonzero(pilots >= 0)[0]:
        cols = present[b, pilots[b]]
        frozen[b] |= cols
        y[b, cols] = 0.25
    f_use, u_need = np.zeros((B, N)), np.zeros((B, N))
    for j in range(W):
        f_use = f_use + weight[:, :, j] * np.where(frozen, y, 0.0)[:, None, j]
        u_need = u_need + weight[:, :, j] * (~frozen)[:, None, j]
    return f_use, u_need


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


def lane_csr(np, present, weight):
    """One dense lane as the port's CSR incidence (the numpy kernels'
    input)."""
    from repro_torch.core.alloc_torch import csr_from_arrays
    N, W = weight.shape
    indptr = np.concatenate([[0], np.cumsum(present.sum(axis=1))])
    rows, cols = np.nonzero(present)
    return csr_from_arrays(N, W, indptr, cols, weight[rows, cols])


def phase_kernels(torch, np):
    from repro_torch.core.alloc_kernels import maxmin_yields_csr
    from repro_torch.kernels.alloc_matvec import (alloc_matvec_cuda,
                                                  alloc_matvec_plain)
    from repro_torch.kernels.maxmin_solve import (maxmin_solve_cuda,
                                                  maxmin_solve_plain,
                                                  solve_route)

    dev = torch.device("cuda")
    rng = np.random.default_rng(2011)
    checks = []
    # N = 100 is ragged against the 16-row group; W = 37 is odd (no
    # 16-byte loads); W = 512 takes eight 64-column chunks
    for shape in [(16, 128, 32), (32, 128, 64), (128, 128, 128), (3, 5, 37),
                  (8, 100, 32), (4, 128, 512), (4, 16, 0)]:
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
    for shape in [(16, 128, 32), (32, 128, 64), (8, 128, 128), (4, 128, 256),
                  (3, 5, 37), (4, 16, 0)]:
        present, weight, active, pilots = solve_inputs(rng, *shape)
        args = [torch.from_numpy(a).to(dev) for a in (present, weight, active)]
        ky, kr = maxmin_solve_cuda(*args)
        py, pr = maxmin_solve_plain(*args)
        torch.cuda.synchronize()
        y = ky.cpu().numpy()
        numpy_bad = sum(
            not np.array_equal(y[b], maxmin_yields_csr(
                lane_csr(np, present[b], weight[b]), active[b]))
            for b in range(shape[0]))
        sets = [s for s in binding_sets(*second_round(present, weight, active,
                                                      pilots), pilots >= 0)
                if s is not None and s[0]]
        near = sum(s[1] for s in sets)
        check = {"kernel": "maxmin_solve", "shape": list(shape),
                 "route": solve_route(*args),
                 "equal_plain": bool(torch.equal(ky, py)),
                 "equal_plain_rounds": bool(torch.equal(kr, pr)),
                 "numpy_mismatched_lanes": numpy_bad,
                 "rounds": kr.tolist(),
                 "empty_lanes": int((~active.any(axis=1)).sum()),
                 # one round, every active column at 1
                 "capped_lanes": int(sum(
                     active[b].any() and int(kr[b]) == 1
                     and bool((y[b][active[b]] == 1.0).all())
                     for b in range(shape[0]))),
                 "binding_lanes": len(sets), "near_tie_lanes": near}
        if shape[1] == N_NODES and shape[2] <= 128:
            # at the cluster's width, most round-2 bottlenecks are near-ties
            check["near_ties_ok"] = 2 * near > len(sets)
        checks.append(check)
    usage_checks, usage_paper = node_usage_checks(torch, np, rng)
    checks += usage_checks
    routes = {c["route"] for c in checks if "route" in c}
    ok = routes == {"shared", "global"} and all(
        c["equal_plain"] and c.get("equal_numpy", True)
        and c.get("equal_plain_rounds", True)
        and c.get("numpy_mismatched_lanes", 0) == 0
        and c.get("near_ties_ok", True)
        and c.get("order_sensitive", True) for c in checks)
    emit({"phase": "kernels", "ok": ok, "tolerance": "bit-exact",
          "checks": checks})
    if not ok:
        raise PhaseFailed("a kernel disagrees with its plain version or the "
                          "numpy kernel, a route went unchecked, or the "
                          "solve's inputs hold too few near-ties")
    return usage_paper


def usage_lists(np, rng, B, N, K):
    """(B, K) node-usage scatter lists: per-lane lengths padded with the
    sentinel N, an empty lane (lane 0), a lane whose first 64 entries
    name one node with values whose sum depends on the order of the adds
    (lane 1), entries outside [0, N] in lane 2, values over 18 orders of
    magnitude."""
    nodes = rng.integers(0, N, (B, K))
    vals = rng.random((B, K)) * rng.choice([1e-9, 1.0, 1e9], (B, K))
    lens = rng.integers(0, K + 1, B)
    for b in range(B):
        nodes[b, lens[b]:] = N
    if B > 0:
        nodes[0] = N
    if B > 1 and K >= 64:
        nodes[1, :64] = N // 2
        vals[1, :64] = np.tile([1.0, 1e-16, -1.0, 3e-17], 16)
    if B > 2 and K >= 4:
        nodes[2, :4] = [-1, N + 5, -7, 2**40]
    return nodes, vals


def add_at_usage(np, nodes, vals, N):
    """The stretch passes' in-order np.add.at, lane by lane."""
    out = np.zeros((nodes.shape[0], N))
    for b in range(nodes.shape[0]):
        keep = (nodes[b] >= 0) & (nodes[b] < N)
        np.add.at(out[b], nodes[b][keep], vals[b][keep])
    return out


def node_usage_checks(torch, np, rng):
    """The node-usage kernel against its plain version on the card and
    against in-order np.add.at, bit for bit: at the stretch passes' paper
    shapes (16 lanes, 128 nodes, up to 128 x 32 entries), and at shapes
    ragged against a CTA's 8 nodes, a warp's 32 entries and a tile's 2,048
    entries; a lane whose every entry names one node (4,096 serial adds),
    negative ids, no entries, and one lane.  Also returns the paper shape's
    inputs and both results, which the kernels line times."""
    from repro_torch.kernels.node_usage import (node_usage_cuda,
                                                node_usage_plain)

    dev = torch.device("cuda")
    checks, paper = [], None
    for case, B, N, K in [
            ("paper", 16, N_NODES, N_NODES * 32), ("ragged", 16, 128, 640),
            ("small", 3, 5, 37), ("tile_ragged", 4, 200, 2049),
            ("no_entries", 2, 16, 0), ("one_node", 2, 128, 4096),
            ("negative_ids", 3, 64, 300), ("k_ragged", 4, 128, 1000),
            ("n_ragged", 4, 203, 2049), ("one_lane", 1, 128, 4096)]:
        nodes, vals = usage_lists(np, rng, B, N, K)
        if case == "one_node":
            nodes[0] = 77                   # K serial adds into one node
        elif case == "negative_ids":
            neg = rng.random((B, K)) < 0.3
            nodes[neg] = -rng.integers(1, N + 1, int(neg.sum()))
        nt = torch.from_numpy(nodes).to(dev)
        vt = torch.from_numpy(vals).to(dev)
        k = node_usage_cuda(nt, vt, N)
        p = node_usage_plain(nt, vt, N)
        torch.cuda.synchronize()
        if paper is None:
            paper = {"nodes": nt, "vals": vt, "n_nodes": N, "kernel": k,
                     "plain": p,
                     "adds": int(((nodes >= 0) & (nodes < N)).sum())}
        check = {"kernel": "node_usage", "case": case, "shape": [B, N, K],
                 "equal_plain": bool(torch.equal(k, p)),
                 "equal_numpy": bool(np.array_equal(
                     k.cpu().numpy(), add_at_usage(np, nodes, vals, N)))}
        if B > 1 and K >= 64:
            fwd = rev = 0.0
            for v in vals[1, :64]:
                fwd += v
            for v in vals[1, 63::-1]:
                rev += v
            check["order_sensitive"] = bool(fwd != rev)
        checks.append(check)
    return checks, paper


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
    names with the most summed seconds and the port's kernels by name.
    Reads kineto's raw events: building the profiler's ``FunctionEvent``
    list instead costs tens of seconds in a phase of many dispatches."""
    spans, by_kind, by_name, by_port = [], Counter(), Counter(), Counter()
    for e in prof.profiler.kineto_results.events():
        if not str(e.device_type()).endswith("CUDA"):
            continue
        name = e.name()
        start = e.start_ns() / 1e3                      # microseconds
        end = start + e.duration_ns() / 1e3
        spans.append((start, end))
        if name.startswith(("Memcpy", "Memset")):
            kind = "copies"
        elif any(k in name for k in _PORT_KERNELS):
            kind = "port_kernels"
            by_port[name[:80]] += (end - start) / 1e6
        else:
            kind = "other_kernels"
        by_kind[kind] += (end - start) / 1e6
        by_name[name[:80]] += (end - start) / 1e6
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


def _traced(torch, fn):
    """``fn()`` on the card with the launch counts zeroed just before and
    read just after, under the device trace; peak device memory over the
    start.  Returns what ``fn`` returned and the numbers."""
    from repro_torch.kernels import ops

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    prof, trace_error = start_device_trace(torch)
    ops.reset_launches()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k: ops.launches[k] for k in ("alloc_matvec", "maxmin_solve")}
    routes = {k: dict(v) for k, v in ops.routes.items() if v}
    peak = torch.cuda.max_memory_allocated() - base
    busy = stop_device_trace(prof, trace_error, wall)
    return out, {"wall_s": wall, "launches": launches, "routes": routes,
                 "max_memory_allocated_bytes": peak,
                 "allocated_before_bytes": base, "device": busy}


def _shapes(stats):
    return {"min_dispatches": sum(stats["min_shapes"].values()),
            "avg_dispatches": sum(stats["avg_shapes"].values()),
            "dispatches": stats["dispatches"], "rounds": stats["rounds"],
            "host_syncs": stats["host_syncs"],
            "serve_min_s": stats["min_s"], "serve_avg_s": stats["avg_s"],
            "min_shapes": {str(k): v for k, v
                           in stats["min_shapes"].most_common(6)},
            "avg_shapes": {str(k): v for k, v
                           in stats["avg_shapes"].most_common(6)}}


def _host_cell(cell):
    """One cell on the host numpy ``Engine``: its ``SimResult``, the run's
    wall and its allocation seconds."""
    _src_on_path()
    from repro_torch.sched.engine import Engine, SimParams
    from repro_torch.workloads.registry import make_trace_ir

    trace = make_trace_ir(cell.workload)        # set-up, not run
    alloc = TimedHostAlloc()
    t0 = time.perf_counter()
    ref = Engine(trace, cell.policy, SimParams(n_nodes=cell.workload.n_nodes),
                 alloc_backend=alloc).run()
    return ref, time.perf_counter() - t0, alloc.seconds


def _call(item):
    fn, job = item
    return fn(job)


def host_pool(items):
    """``fn(job)`` for each ``(fn, job)`` of ``items`` in a forkserver pool
    (no worker is a fork of this process's CUDA context), one process a
    job up to one a core, the jobs handed out in the order given.  The
    fork server imports this script and the port once, so a worker starts
    with them loaded.  Callers start it only once the card's timed runs
    that it checks have ended; its workers run at nice 10, so that the
    other parts' card runs, which share the host, go first.  Returns
    (results in order, the pool's wall)."""
    import multiprocessing

    t0 = time.perf_counter()
    ctx = multiprocessing.get_context("forkserver")
    ctx.set_forkserver_preload(["__main__", "repro_torch.api"])
    with ctx.Pool(min(len(items), os.cpu_count() or 1),
                  initializer=os.nice, initargs=(HOST_NICE,)) as pool:
        out = list(pool.imap(_call, items, chunksize=1))
    return out, time.perf_counter() - t0


def host_check(fn, jobs, finish):
    """A phase's host reference runs, ``fn(job)`` for each of ``jobs`` in
    a :func:`host_pool`, then its check, ``finish(results, pool wall)``
    (which emits the phase's line and raises :class:`PhaseFailed`);
    returns what the check returned."""
    results, wall = host_pool([(fn, job) for job in jobs])
    return finish(results, wall)


def _src_on_path():
    if str(ROOT / "src") not in sys.path:
        sys.path.insert(0, str(ROOT / "src"))


def drive_cells(torch, np, cells):
    """``run_batched`` over ``cells`` on the card: the records, the sweep's
    wall, the launch counts and routes (zeroed just before the run, read
    just after), peak device memory over the start and the traced busy
    share.  :func:`check_cells` adds the host runs' check."""
    from repro_torch.sched.sweep import run_batched
    from repro_torch.workloads.registry import make_trace_ir

    for c in cells:
        make_trace_ir(c.workload)               # traces are set-up, not run
    res, line = _traced(torch, lambda: run_batched(cells, device="cuda"))
    return {"res": res, "line": line, "launches": line["launches"]}


def check_cells(np, run, cells, hosts, pool_wall):
    """A :func:`drive_cells` run with each cell's host numpy ``Engine`` run
    (:func:`_host_cell`, from a pool): each cell's host wall, the host
    runs' allocation seconds, the pool's wall and the cells whose outcome
    fields differ from the host run (or whose max stretch is not finite
    and at least 1)."""
    mismatches = []
    for c, rec, (ref, _, _) in zip(cells, run["res"].records, hosts):
        bad = [k for k in _OUTCOMES if rec[k] != getattr(ref, k)]
        if not np.isfinite(rec["max_stretch"]) or rec["max_stretch"] < 1.0:
            bad.append("max_stretch not finite and >= 1")
        if bad:
            mismatches.append({"cell": c.name, "fields": bad})
    return {**run, "host_walls": [h[1] for h in hosts],
            "host_alloc_s": sum(h[2] for h in hosts),
            "host_pool_wall_s": pool_wall,
            "mismatches": mismatches, "host_results": [h[0] for h in hosts]}


def sweep_line(run):
    """The sweep's numbers of a :func:`drive_cells` run, for a phase line."""
    n = len(run["res"].records)
    return {"cells_per_s": n / run["line"]["wall_s"], **run["line"],
            **_shapes(run["res"].alloc_stats)}


def phase_slice(torch, np):
    """Phase 4 on the card, then its host check.  Returns the launch
    counts, the allocator's stats and the seed-0 OPT=MIN cell on the card
    and on the host, phase 4e's yardstick."""
    from repro_torch.sched.sweep import Cell
    from repro_torch.workloads.registry import WorkloadSpec

    def w(seed):
        return WorkloadSpec("lublin", n_jobs=N_JOBS, n_nodes=N_NODES,
                            seed=seed, load=LOAD)

    cells = ([Cell(w(s), "GreedyP */OPT=MIN") for s in range(MIN_SEEDS)]
             + [Cell(w(s), "Greedy */OPT=AVG") for s in range(2)]
             + [Cell(w(s), "EASY") for s in range(2)])
    run = drive_cells(torch, np, cells)
    res, launches = run["res"], run["launches"]

    def finish(hosts, pool_wall):
        checked = check_cells(np, run, cells, hosts, pool_wall)
        ok = not checked["mismatches"] and all(v > 0
                                               for v in launches.values())
        emit({"phase": "slice", "ok": ok, "cells": len(cells),
              "min_seeds": MIN_SEEDS,
              "n_jobs": N_JOBS, "n_nodes": N_NODES, "load": LOAD,
              **sweep_line(checked),
              "host_reference_wall_s": sum(checked["host_walls"]),
              "host_reference_alloc_s": checked["host_alloc_s"],
              "host_pool_wall_s": pool_wall,
              "mismatches": checked["mismatches"],
              "max_stretch": [rec["max_stretch"] for rec in res.records]})
        if not ok:
            raise PhaseFailed("the slice disagrees with the host run or did "
                              "not reach a kernel")
        return res.records[0], checked["host_results"][0]
    seed0 = host_check(_host_cell, cells, finish)
    return launches, res.alloc_stats, seed0


def phase_slice_mcb8(torch, np):
    """The paper's MCB8 policy family on the card: MCB8 re-packs, the /per
    and /stretch-per passes, each followed by the §4.6 reallocation
    through the lockstep dispatcher, on Lublin and on HPC2N; then the
    host check."""
    from repro_torch.sched.sweep import Cell
    from repro_torch.workloads.registry import WorkloadSpec

    lublin = WorkloadSpec("lublin", n_jobs=N_JOBS, n_nodes=N_NODES, seed=0,
                          load=LOAD)
    hpc2n = WorkloadSpec("hpc2n", n_jobs=HPC2N_JOBS, n_nodes=N_NODES, seed=0)
    cells = ([Cell(lublin, p) for p in MCB8_LUBLIN]
             + [Cell(hpc2n, p) for p in MCB8_HPC2N])
    run = drive_cells(torch, np, cells)
    res, launches = run["res"], run["launches"]

    def finish(hosts, pool_wall):
        checked = check_cells(np, run, cells, hosts, pool_wall)
        host_by_policy = Counter()
        for c, s in zip(cells, checked["host_walls"]):
            host_by_policy[f"{c.workload.kind} {c.policy}"] += s
        ok = not checked["mismatches"] and all(v > 0
                                               for v in launches.values())
        emit({"phase": "slice mcb8", "ok": ok, "cells": len(cells),
              "lublin": lublin.to_dict(), "hpc2n": hpc2n.to_dict(),
              **sweep_line(checked),
              "host_reference_wall_s": sum(checked["host_walls"]),
              "host_reference_alloc_s": checked["host_alloc_s"],
              "host_reference_s_by_cell": dict(host_by_policy),
              "host_pool_wall_s": pool_wall,
              "mismatches": checked["mismatches"],
              "stretch": {f"{c.workload.kind} {c.policy}":
                          {"max": rec["max_stretch"],
                           "mean": rec["mean_stretch"],
                           "n_mig": rec["n_mig"], "n_pmtn": rec["n_pmtn"]}
                          for c, rec in zip(cells, res.records)}})
        if not ok:
            raise PhaseFailed("the MCB8 slice disagrees with the host run or "
                              "did not reach a kernel")
    host_check(_host_cell, cells, finish)


def write_swf_log(np, path, n_jobs, seed, mean_gap):
    """A submit-sorted synthetic swf log, written line by line: the scale
    benchmark's recipe (exponential gaps, runs uniform in 60-6000 s, 1-32
    processors, 5-45 % of a node's memory)."""
    from repro_torch.workloads.hpc2n import NODE_MEM_GB

    rng = np.random.default_rng(seed)
    node_kb = NODE_MEM_GB * 1024 * 1024
    t = 0.0
    with open(path, "w") as fh:
        fh.write(f"; synthetic log: {n_jobs} jobs, seed {seed}\n")
        gaps = rng.exponential(mean_gap, size=n_jobs)
        runs = rng.uniform(60.0, 6000.0, size=n_jobs)
        procs = rng.integers(1, 33, size=n_jobs)
        mems = rng.uniform(0.05, 0.45, size=n_jobs) * node_kb
        for jid, (g, run, p, mem) in enumerate(zip(gaps, runs, procs, mems)):
            t += float(g)
            f = ["-1"] * 18
            f[0] = str(jid + 1)
            f[1] = f"{t:.1f}"
            f[3] = f"{run:.1f}"
            f[4] = str(int(p))
            f[6] = f"{mem:.0f}"
            fh.write(" ".join(f) + "\n")


def _result_fields(r):
    d = dataclasses.asdict(r)
    d.pop("sim_wall_s")                 # a measurement, not an outcome
    return d


def _session_host(job):
    """A host reference run of phase 4c, in a pool process: ``("stream",
    path)``, the numpy ``Engine`` over the whole swf log, uncompacted:
    (result, wall, allocation seconds); or ``("branch", snapshot path, i,
    policy)``, what-if branch i alone on the host numpy path: its record
    (with ``cell`` and ``branch`` i)."""
    _src_on_path()
    from repro_torch.sched.engine import Engine, SimParams
    from repro_torch.sched.sweep import run_branches
    from repro_torch.workloads.registry import WorkloadSpec, make_trace_ir

    if job[0] == "stream":
        whole = make_trace_ir(WorkloadSpec("swf", n_jobs=STREAM_JOBS,
                                           n_nodes=N_NODES,
                                           params={"path": job[1]}))
        alloc = TimedHostAlloc()
        t0 = time.perf_counter()
        ref = Engine(whole, SESSION_POLICY, SimParams(n_nodes=N_NODES),
                     alloc_backend=alloc).run()
        return ref, time.perf_counter() - t0, alloc.seconds
    _, path, i, policy = job
    rec = run_branches(path, [policy], backend="numpy").records[0]
    return dict(rec, cell=i, branch=i)


def session_stream(torch, np, tmp):
    """(a) the swf log streamed through a compacting session on the card;
    the line, without the host check, and the host job that checks it
    (:func:`_session_host`, :func:`stream_check`)."""
    from repro_torch.sched.engine import SimParams
    from repro_torch.sched.session import open_session
    from repro_torch.workloads.lublin import offered_load
    from repro_torch.workloads.registry import (WorkloadSpec, make_trace_ir,
                                                stream_trace)

    path = str(Path(tmp) / "stream.swf")
    write_swf_log(np, path, STREAM_JOBS, 0, STREAM_GAP_S)
    whole = make_trace_ir(WorkloadSpec("swf", n_jobs=STREAM_JOBS,
                                       n_nodes=N_NODES,
                                       params={"path": path}))
    load = offered_load(whole.to_specs(), N_NODES)
    spec = WorkloadSpec("swf-stream", n_jobs=STREAM_JOBS, n_nodes=N_NODES,
                        params={"path": path})
    peak = {"rows": 0, "chunks": 0}

    def run():
        ses = open_session(SimParams(n_nodes=N_NODES,
                                     compact_interval=COMPACT_AT),
                           SESSION_POLICY, device="cuda")
        st = ses.engine.state

        def watched(chunks):
            # a chunk is submitted after the next one is drawn, so the rows
            # right after each submit are the rows now plus the last chunk
            prev = 0
            for c in chunks:
                peak["rows"] = max(peak["rows"], len(st.specs) + prev)
                peak["chunks"] += 1
                prev = len(c)
                yield c
            peak["rows"] = max(peak["rows"], len(st.specs) + prev)

        ses.stream(watched(stream_trace(spec, window_s=STREAM_WINDOW_S)))
        return ses, ses.result()

    (ses, got), line = _traced(torch, run)
    st = ses.engine.state
    return {"jobs": len(whole), "offered_load": load,
            "window_s": STREAM_WINDOW_S, "compact_interval": COMPACT_AT,
            "chunks": peak["chunks"], "events": got.events,
            "events_per_s": got.events / line["wall_s"],
            "final_time": got.final_time, "max_stretch": got.max_stretch,
            "mean_stretch": got.mean_stretch, **line,
            **_shapes(ses.engine.alloc_backend.stats),
            "peak_engine_rows": peak["rows"], "row_capacity": st.capacity,
            "grow_count": st.grow_count, "retired_rows": len(st.retired),
            "result": got}, ("stream", path)


def stream_check(np, line, host):
    """(a)'s line with its host check: every ``SimResult`` field against
    the host run of the whole log."""
    got = line.pop("result")
    ref, wall, alloc_s = host
    a, b = _result_fields(got), _result_fields(ref)
    bad = sorted(k for k in a if a[k] != b[k])
    if not np.isfinite(got.max_stretch) or got.max_stretch < 1.0:
        bad.append("max_stretch not finite and >= 1")
    return {**line, "host_reference_wall_s": wall,
            "host_reference_alloc_s": alloc_s, "mismatches": bad}


def _branch_name(entry):
    if isinstance(entry, dict):
        return f"{entry['policy']} period {entry['period']:g}"
    return entry


def session_branches(torch, np, tmp):
    """(b) what-if branches from a snapshot of a session on the card, raced
    in lockstep; the same-policy branch against the original session
    continued on the card.  Returns the line, without the host check, and
    the host jobs that check it, a branch each (:func:`_session_host`,
    :func:`branches_check`)."""
    from repro_torch.sched.session import SessionState, open_session
    from repro_torch.sched.sweep import run_branches
    from repro_torch.workloads.registry import WorkloadSpec, make_trace_ir

    lublin = WorkloadSpec("lublin", n_jobs=N_JOBS, n_nodes=N_NODES, seed=0,
                          load=LOAD)
    trace = make_trace_ir(lublin)
    ses = open_session(N_NODES, SESSION_POLICY, device="cuda")
    ses.submit(trace)
    t_branch = float(np.sort(trace.release)[BRANCH_AT - 1])
    ses.step_until(t_branch)
    ses.inject({"kind": "fail", "t": ses.now + 600.0,
                "nodes": list(FAIL_NODES)})
    ses.inject({"kind": "join", "t": ses.now + 7200.0,
                "nodes": list(FAIL_NODES)})
    at = ses.observe()
    snap = ses.snapshot()
    path = snap.save(str(Path(tmp) / "snap.json"))
    back = SessionState.load(path)
    res, line = _traced(torch, lambda: run_branches(back, BRANCHES,
                                                    device="cuda"))
    t0 = time.perf_counter()
    cont = ses.run()
    cont_wall = time.perf_counter() - t0
    same = res.records[0]
    cont_bad = [k for k in _OUTCOMES
                if k in same and same[k] != getattr(cont, k)]
    if not same["exact_continuation"]:
        cont_bad.append("exact_continuation")
    return {"trace": lublin.to_dict(), "branch_at_release": BRANCH_AT,
            "t": at["t"], "running": at["n_running"],
            "queued": at["queue_depth"], "done": at["n_completed"],
            "fail_nodes": list(FAIL_NODES),
            "fingerprint": snap.fingerprint,
            "round_trip_ok": back.fingerprint == snap.fingerprint,
            "branches": {_branch_name(BRANCHES[r["cell"]]):
                         {"max_stretch": r["max_stretch"],
                          "events": r["events"], "wall_s": r["wall_s"]}
                         for r in res.records},
            **line, **_shapes(res.alloc_stats),
            "continuation_wall_s": cont_wall,
            "continuation_mismatches": cont_bad,
            "records": res.records}, [("branch", path, i, b)
                                      for i, b in enumerate(BRANCHES)]


def branches_check(np, line, host):
    """(b)'s line with its host check: each branch's record against its
    host run alone, every field but the walls and the backend."""
    skip = ("wall_s", "sim_wall_s", "backend")
    mismatches = []
    for rec, ref in zip(line.pop("records"), host):
        bad = sorted(k for k in ref if k not in skip and rec.get(k) != ref[k])
        if not np.isfinite(rec["max_stretch"]) or rec["max_stretch"] < 1.0:
            bad.append("max_stretch not finite and >= 1")
        if bad:
            mismatches.append({"branch": rec["cell"], "fields": bad})
    return {**line, "host_by_branch_s": [r["wall_s"] for r in host],
            "mismatches": mismatches}


def phase_slice_session(torch, np):
    """Open sessions on the card: a long swf log streamed with row
    compaction, and what-if branches raced in lockstep; then the host
    checks, which read the log and the snapshot from a temporary
    directory."""
    import tempfile

    with tempfile.TemporaryDirectory() as tmp:
        return _slice_session(torch, np, tmp)


class _Enough(Exception):
    """Stops a host engine once it has handed out the incidences wanted."""


def session_surface(torch, np, tmp, log_path):
    """(c) the swf log's ``Trace`` through npz and JSON files, and the
    one-lane MIN solve on the card against the host solve, bit for bit, on
    incidences a host engine hands out on phase 4's Lublin trace (seed 0).
    Prints its line; raises :class:`PhaseFailed` on any difference."""
    from repro_torch.core.alloc_kernels import maxmin_yields_csr
    from repro_torch.core.alloc_torch import maxmin_yields_torch
    from repro_torch.core.yield_alloc import allocate_incidence
    from repro_torch.sched.engine import Engine, SimParams
    from repro_torch.workloads.registry import WorkloadSpec, make_trace_ir
    from repro_torch.workloads.trace import Trace

    t0 = start = time.perf_counter()
    whole = make_trace_ir(WorkloadSpec("swf", n_jobs=STREAM_JOBS,
                                       n_nodes=N_NODES,
                                       params={"path": log_path}))
    files = {}
    for fmt, save, load in (("npz", whole.save_npz, Trace.load_npz),
                            ("json", whole.save_json, Trace.load_json)):
        path = save(str(Path(tmp) / f"log.{fmt}"))
        back = load(path)
        files[fmt] = {"bytes": os.path.getsize(path),
                      "fingerprint_equal": back.fingerprint
                      == whole.fingerprint,
                      "total_work_equal": back.total_work
                      == whole.total_work}
    files_wall = time.perf_counter() - t0

    kept, calls = [], [0]

    class Keep:
        def allocate(self, inc, cols, opt="MIN"):
            calls[0] += 1
            if calls[0] % SURFACE_EVERY == 0:
                kept.append((inc, np.array(cols)))
                if len(kept) == SURFACE_INCIDENCES:
                    raise _Enough
            return allocate_incidence(inc, cols, opt=opt)

    trace = make_trace_ir(WorkloadSpec("lublin", n_jobs=N_JOBS,
                                       n_nodes=N_NODES, seed=0, load=LOAD))
    try:
        Engine(trace, SESSION_POLICY, SimParams(n_nodes=N_NODES),
               alloc_backend=Keep()).run()
    except _Enough:
        pass
    t0 = time.perf_counter()
    solves = []
    for inc, cols in kept:
        active = np.zeros(inc.width, dtype=bool)
        active[cols] = True
        got = maxmin_yields_torch(inc, active, device="cuda")
        want = maxmin_yields_csr(inc, active)
        solves.append({"nodes": inc.n_nodes, "width": inc.width,
                       "running": int(active.sum()),
                       "bit_equal": got.dtype == want.dtype
                       and np.array_equal(got.view(np.int64),
                                          want.view(np.int64))})
    solve_wall = time.perf_counter() - t0
    ok = (all(f["fingerprint_equal"] and f["total_work_equal"]
              for f in files.values())
          and len(solves) == SURFACE_INCIDENCES
          and all(x["bit_equal"] for x in solves))
    emit({"phase": "slice session surface", "ok": ok,
          "wall_s": time.perf_counter() - start,
          "trace_files": {"jobs": len(whole), "wall_s": files_wall,
                          **files},
          "maxmin_yields_torch": {"trace": "lublin seed 0",
                                  "policy": SESSION_POLICY,
                                  "every": SURFACE_EVERY,
                                  "wall_s": solve_wall,
                                  "incidences": solves}})
    if not ok:
        raise PhaseFailed("a trace file did not load back equal, or the "
                          "one-lane solve differs from the host's")


def _slice_session(torch, np, tmp):
    stream, stream_job = session_stream(torch, np, tmp)
    branches, branch_jobs = session_branches(torch, np, tmp)
    session_surface(torch, np, tmp, stream_job[1])

    def finish(hosts, pool_wall):
        s = stream_check(np, stream, hosts[0])
        b = branches_check(np, branches, hosts[1:])
        ok = (not s["mismatches"] and not b["mismatches"]
              and not b["continuation_mismatches"]
              and b["round_trip_ok"]
              and s["launches"]["maxmin_solve"] > 0
              and b["launches"]["maxmin_solve"] > 0
              and b["launches"]["alloc_matvec"] > 0)
        emit({"phase": "slice session", "ok": ok, "policy": SESSION_POLICY,
              "host_pool_wall_s": pool_wall, "stream": s, "branches": b})
        if not ok:
            raise PhaseFailed("a session disagrees with the host run, or "
                              "did not reach a kernel")
    # the whole log's host run is the longest job: handed out first
    host_check(_session_host, [stream_job] + branch_jobs, finish)
    return {"stream": stream["launches"], "branches": branches["launches"]}


# --------------------------------------------------------------------------- #
# phase 4d: scenario grids, chaos, the autotuner                               #
# --------------------------------------------------------------------------- #
def _outcome_diff(np, rec, ref, skip=("wall_s", "sim_wall_s", "backend",
                                      "cell", "sim_params")):
    """Fields of two sweep records that differ (the clocks, the backend tag,
    the grid index and the cache's key field aside), and a max stretch
    that is not finite and at least 1."""
    keys = (set(rec) | set(ref)) - set(skip)
    bad = sorted(k for k in keys if rec.get(k) != ref.get(k))
    if not rec.get("quarantined") and (
            not np.isfinite(rec["max_stretch"]) or rec["max_stretch"] < 1.0):
        bad.append("max_stretch not finite and >= 1")
    return bad


def scenario_cells():
    """Phase 4d (a)'s 14 cells, as the groups ``api.sweep`` takes (each a
    cross product) and as one flat list."""
    from repro_torch.sched.sweep import Cell
    from repro_torch.workloads.registry import WorkloadSpec

    lublin = WorkloadSpec("lublin", n_jobs=N_JOBS, n_nodes=N_NODES, seed=0,
                          load=LOAD)
    tpu = WorkloadSpec("tpu", n_jobs=N_JOBS, n_nodes=N_NODES, seed=0)
    groups = [(lublin, SCEN_POLICIES, SCEN_CHAINS),
              (lublin, ("EASY",), ("rack_failure",)),
              (lublin, ("Greedy */OPT=AVG",), ("rolling_failures",)),
              (tpu, TPU_POLICIES, ("baseline",))]
    cells = [Cell(w, p, sc) for w, pols, chains in groups
             for p in pols for sc in chains]
    return groups, cells


def scenario_grid(torch, np, tmp):
    """(a) ``run_grid`` on the card against the supervised host pool, then
    ``api.sweep`` over the same grid with a record cache, twice."""
    from repro_torch import api
    from repro_torch.sched import sweep as sweep_mod
    from repro_torch.sched.sweep import RecordCache, run_grid
    from repro_torch.workloads.registry import make_trace_ir

    groups, cells = scenario_cells()
    for c in cells:
        make_trace_ir(c.workload)               # traces are set-up, not run
    res, line = _traced(torch, lambda: run_grid(
        cells, backend="torch", compute_bound=True, device="cuda"))
    t0 = time.perf_counter()
    host = run_grid(cells, backend="numpy", n_workers=SCEN_WORKERS,
                    timeout_s=600, retries=1, compute_bound=True)
    host_wall = time.perf_counter() - t0
    mismatches = []
    for c, rec, ref in zip(cells, res.records, host.records):
        bad = _outcome_diff(np, rec, ref)
        if "bound" not in rec or "degradation" not in rec:
            bad.append("no bound")
        if bad:
            mismatches.append({"cell": f"{c.workload.kind} {c.policy} "
                                       f"{c.scenario}", "fields": bad})

    # api.sweep over the same grid, twice, counting the cells it hands to
    # run_grid (the misses it simulates)
    path = str(Path(tmp) / "cache.json")
    simulated = []
    grid_fn = sweep_mod.run_grid

    def counting(cells, **kw):
        simulated[-1] += len(cells)
        return grid_fn(cells, **kw)

    def sweep_all():
        simulated.append(0)
        return [rec for w, pols, chains in groups
                for rec in api.sweep([w], pols, chains, cache_path=path,
                                     device="cuda").records]

    sweep_mod.run_grid = counting
    try:
        first, first_line = _traced(torch, sweep_all)
        second, second_line = _traced(torch, sweep_all)
    finally:
        sweep_mod.run_grid = grid_fn
    sweep_bad = [i for i, (a, ref) in enumerate(zip(first, host.records))
                 if _outcome_diff(np, a, ref)]
    cached_equal = first == second          # wall_s too: nothing re-ran
    n_cached = len(RecordCache(path))
    by_cell = {f"{c.workload.kind} {c.policy} {c.scenario}":
               {"max_stretch": r["max_stretch"], "degradation":
                r["degradation"], "events": r["events"],
                "scenario_applied": r["scenario_applied"],
                "lane_wall_s": r["wall_s"], "host_wall_s": h["wall_s"]}
               for c, r, h in zip(cells, res.records, host.records)}
    return {"cells": len(cells), **line,
            "cells_per_s": len(cells) / line["wall_s"],
            **_shapes(res.alloc_stats),
            "quarantined": res.n_quarantined + host.n_quarantined,
            "host_pool_wall_s": host_wall, "host_pool_workers": SCEN_WORKERS,
            "host_pool_cells_per_s": len(cells) / host_wall,
            "host_cell_s_sum": sum(r["wall_s"] for r in host.records),
            "mismatches": mismatches, "by_cell": by_cell,
            "sweep": {"first_wall_s": first_line["wall_s"],
                      "first_simulated": simulated[0],
                      "first_launches": first_line["launches"],
                      "second_wall_s": second_line["wall_s"],
                      "second_simulated": simulated[1],
                      "second_launches": second_line["launches"],
                      "cached_records": n_cached,
                      "second_equals_first": cached_equal,
                      "mismatches_against_host": sweep_bad}}


def _chaos_session(trace, narrator_spec, **where):
    from repro_torch.sched.narrator import parse_narrator
    from repro_torch.sched.session import open_session

    ses = open_session(N_NODES, SESSION_POLICY, **where)
    ses.attach_narrator(parse_narrator(narrator_spec, seed=NARRATOR_SEED))
    ses.submit(trace)
    return ses


def _scenario_host(job):
    """A host numpy reference run of phase 4d, in a pool process:
    ``"chaos"``, (b)'s session (its result and wall); ``"demo"`` and
    ``"paper"``, (c)'s tuned sessions (their result fields, the tuner's
    decisions and race walls, the wall)."""
    _src_on_path()
    from repro_torch.workloads.registry import WorkloadSpec, make_trace_ir

    t0 = time.perf_counter()
    if job == "demo":
        ses, tuner, walls = _tuned_demo(alloc_backend="numpy")
    else:
        trace = make_trace_ir(WorkloadSpec("lublin", n_jobs=N_JOBS,
                                           n_nodes=N_NODES, seed=0,
                                           load=LOAD))
        if job == "chaos":
            res = _chaos_session(trace, CHAOS, alloc_backend="numpy").run()
            return res, time.perf_counter() - t0
        ses, tuner, walls = _tuned_paper(trace, alloc_backend="numpy")
    return (_result_fields(ses.result()), tuner.decisions, walls,
            time.perf_counter() - t0)


def chaos_session(torch, np, tmp):
    """(b) a session under the chaos narrator on the card, stepped to its
    500th release, saved, loaded and restored on the card, against the
    uninterrupted card run.  Returns the line without its host check and
    the host job (:func:`_scenario_host`, :func:`chaos_check`)."""
    from repro_torch.sched.session import SessionState, SimSession
    from repro_torch.workloads.registry import WorkloadSpec, make_trace_ir

    trace = make_trace_ir(WorkloadSpec("lublin", n_jobs=N_JOBS,
                                       n_nodes=N_NODES, seed=0, load=LOAD))
    t_at = float(np.sort(trace.release)[BRANCH_AT - 1])

    def whole():
        ses = _chaos_session(trace, CHAOS, device="cuda")
        return ses, ses.run()

    (ses, ref_card), line = _traced(torch, whole)

    def split():
        a = _chaos_session(trace, CHAOS, device="cuda")
        a.step_until(t_at)
        path = a.snapshot().save(str(Path(tmp) / "chaos.json"))
        back = SessionState.load(path)
        return back, SimSession.restore(back, device="cuda").run()

    (back, got), split_line = _traced(torch, split)
    kinds = Counter(ev.kind for ev in ses._cev)
    obs = ses.observe()
    return {"narrator": CHAOS, "narrator_seed": NARRATOR_SEED,
            "restored_at_release": BRANCH_AT, "restored_at_t": t_at,
            "snapshot_has_narrator": "narrator" in back.payload,
            "injections": {**dict(kinds), "noisy_jobs": obs["n_noisy"]},
            "events": ref_card.events,
            "events_per_s": ref_card.events / line["wall_s"],
            "final_time": ref_card.final_time,
            "max_stretch": ref_card.max_stretch,
            "mean_stretch": ref_card.mean_stretch,
            "n_cancelled": obs["n_cancelled"], **line,
            **_shapes(ses.engine.alloc_backend.stats),
            "split_wall_s": split_line["wall_s"],
            "split_launches": split_line["launches"],
            "results": (got, ref_card)}, "chaos"


def chaos_check(np, line, host):
    """(b)'s line with its host check: the restored run against the
    uninterrupted card run and the host run, every ``SimResult`` field."""
    got, ref_card = line.pop("results")
    res, wall = host
    a, b, h = (_result_fields(r) for r in (got, ref_card, res))
    bad = sorted({k for k in a if a[k] != b[k] or a[k] != h[k]})
    if not np.isfinite(got.max_stretch) or got.max_stretch < 1.0:
        bad.append("max_stretch not finite and >= 1")
    return {**line, "host_wall_s": wall, "mismatches": bad}


def _timed_fires(tuner):
    """Wrap ``tuner.fire`` so each race's wall is kept (the session's loop
    calls it through the instance)."""
    walls = []
    fire = tuner.fire

    def timed(session, **kw):
        t0 = time.perf_counter()
        try:
            return fire(session, **kw)
        finally:
            walls.append(time.perf_counter() - t0)

    tuner.fire = timed
    return walls


def _tuned_demo(**where):
    from repro_torch import api

    ses = api.open_session(TUNE_NODES, TUNE_INCUMBENT, **where)
    tuner = api.autotune(ses, TUNE_SPEC, seed=TUNER_SEED)
    walls = _timed_fires(tuner)
    ses.submit(api.parse_workload("lublin", n_jobs=TUNE_JOBS,
                                  n_nodes=TUNE_NODES, seed=TUNE_SEED,
                                  load=TUNE_LOAD))
    ses.inject({"kind": "fail", "t": TUNE_FAIL_T, "nodes": list(TUNE_RACK)})
    ses.inject({"kind": "join", "t": TUNE_JOIN_T, "nodes": list(TUNE_RACK)})
    ses.run_to_exhaustion()
    return ses, tuner, walls


def _tuned_paper(trace, **where):
    from repro_torch import api

    ses = _chaos_session(trace, CHAOS_TUNED, **where)
    tuner = api.autotune(ses, TUNE_PAPER_SPEC, seed=TUNER_SEED)
    walls = _timed_fires(tuner)
    ses.step_until(TUNE_PAPER_UNTIL_S)
    return ses, tuner, walls


def _tune_line(ses, tuner, walls):
    r = ses.result()
    obs = ses.observe()
    return {"races": len(tuner.decisions),
            "rungs": [len(d.get("rungs", ())) for d in tuner.decisions],
            "race_wall_s": walls,
            "swaps": [{"t": d["t"], "to": d["winner"]["policy"]}
                      for d in tuner.decisions if d["swapped"]],
            "final_policy": ses.policy_name, "exhausted": ses.exhausted,
            "completed": obs["n_completed"], "paused": obs["n_paused"],
            "max_stretch": r.max_stretch, "events": r.events}


def tuned_sessions(torch, np):
    """(c) the autotuner, its races in lockstep on the card: the reference's
    demo, then a paper-size session under chaos.  Returns the lines
    without their host checks and the host jobs (:func:`_scenario_host`,
    :func:`tune_check`)."""
    from repro_torch.workloads.registry import WorkloadSpec, make_trace_ir

    (ses, tuner, walls), line = _traced(torch, lambda: _tuned_demo(
        device="cuda"))
    demo = {**_tune_line(ses, tuner, walls), **line,
            "card": (_result_fields(ses.result()), tuner.decisions)}
    swaps = demo["swaps"]
    demo["reference_demo_ok"] = (
        len(swaps) == 1 and swaps[0]["t"] == 6000.0
        and swaps[0]["to"] == TUNE_PORTFOLIO[1]
        and round(demo["max_stretch"], 6) == TUNE_DEMO_STRETCH)

    trace = make_trace_ir(WorkloadSpec("lublin", n_jobs=N_JOBS,
                                       n_nodes=N_NODES, seed=0, load=LOAD))
    (ses, tuner, walls), line = _traced(torch, lambda: _tuned_paper(
        trace, device="cuda"))
    st = ses.engine.state
    paper = {**_tune_line(ses, tuner, walls), **line,
             "narrator": CHAOS_TUNED, "spec": TUNE_PAPER_SPEC,
             "until_s": TUNE_PAPER_UNTIL_S,
             "paused_widths": [st.specs[i].n_tasks
                               for i in st.in_system_indices()],
             "card": (_result_fields(ses.result()), tuner.decisions)}
    return {"demo": demo, "paper": paper}, ["demo", "paper"]


def tune_check(line, host):
    """A tuned session's line with its host check: the host tuner's
    decisions and result against the card's."""
    result, decisions = line.pop("card")
    h_result, h_decisions, h_walls, h_wall = host
    return {**line, "host_wall_s": h_wall, "host_race_wall_s": h_walls,
            "decisions_equal": decisions == h_decisions,
            "result_equal": result == h_result}


def phase_slice_scenarios(torch, np):
    """Scenario grids on the card against the supervised host pool, a
    record cache, a chaos session restored mid-run, and the autotuner;
    then the chaos and tuner host runs and the phase's check.  Returns
    the launch counts by part."""
    return scenarios_check(scenarios_grid(torch, np),
                           scenarios_sessions(torch, np))


def scenarios_grid(torch, np):
    """Phase 4d (a) and its line: :func:`scenario_grid`, and the part's
    seconds."""
    import tempfile

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        grid_part = scenario_grid(torch, np, tmp)
    emit({"phase": "slice scenarios", "part": "grid", **grid_part})
    return grid_part, time.perf_counter() - t0


def scenarios_sessions(torch, np):
    """Phase 4d (b) and (c) on the card, then their host runs and their
    lines.  Returns (the chaos line, the tune lines by name, the host
    pool's wall, the card runs' seconds)."""
    import tempfile

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        chaos, chaos_job = chaos_session(torch, np, tmp)
    tune, tune_jobs = tuned_sessions(torch, np)
    card_s = time.perf_counter() - t0

    def finish(hosts, pool_wall):
        checked = chaos_check(np, chaos, hosts[0])
        emit({"phase": "slice scenarios", "part": "chaos", **checked})
        tuned = {k: tune_check(tune[k], h)
                 for k, h in zip(tune_jobs, hosts[1:])}
        emit({"phase": "slice scenarios", "part": "tune",
              "host_pool_wall_s": pool_wall, **tuned})
        return checked, tuned, pool_wall, card_s
    return host_check(_scenario_host, [chaos_job] + tune_jobs, finish)


def scenarios_check(grid, sessions):
    """Phase 4d's line from its parts, :func:`scenarios_grid` and
    :func:`scenarios_sessions`; returns the launch counts by part."""
    (grid_part, grid_s), (chaos, tune, pool_wall, card_s) = grid, sessions
    sw = grid_part["sweep"]
    demo, paper = tune["demo"], tune["paper"]
    ok = (not grid_part["mismatches"] and grid_part["quarantined"] == 0
          and sw["first_simulated"] == grid_part["cells"]
          and sw["second_simulated"] == 0
          and sw["second_equals_first"]
          and not sw["mismatches_against_host"]
          and sw["cached_records"] == grid_part["cells"]
          and all(v == 0 for v in sw["second_launches"].values())
          and grid_part["launches"]["maxmin_solve"] > 0
          and grid_part["launches"]["alloc_matvec"] > 0
          and not chaos["mismatches"] and chaos["snapshot_has_narrator"]
          and chaos["launches"]["maxmin_solve"] > 0
          and demo["reference_demo_ok"] and demo["decisions_equal"]
          and demo["result_equal"] and demo["launches"]["maxmin_solve"] > 0
          and paper["decisions_equal"] and paper["result_equal"]
          and paper["launches"]["maxmin_solve"] > 0)
    emit({"phase": "slice scenarios", "ok": ok,
          "card_parts_wall_s": grid_s + card_s,
          "parts_wall_s": {"grid": grid_part["wall_s"],
                           "host_pool": grid_part["host_pool_wall_s"],
                           "sweep": sw["first_wall_s"] + sw["second_wall_s"],
                           "chaos": chaos["wall_s"],
                           "tune_demo": demo["wall_s"],
                           "tune_paper": paper["wall_s"],
                           "host_checks_pool": pool_wall}})
    if not ok:
        raise PhaseFailed("a scenario grid, the chaos session or a tuned "
                          "session disagrees with its host run, or did not "
                          "reach a kernel")
    return {"grid": grid_part["launches"], "sweep": sw["first_launches"],
            "chaos": chaos["launches"], "tune_demo": demo["launches"],
            "tune_paper": paper["launches"]}


# --------------------------------------------------------------------------- #
# phase 4e: the multi-tenant session server                                    #
# --------------------------------------------------------------------------- #
# (a) 4 tenants x 128 sessions over 64 live, each session Lublin (100 jobs,
# load 0.7, its index as the seed) on 128 nodes stepped to 1,800 s; one
# session a tenant (its first) under OPT=AVG; a parity sample of 2 a tenant
SERVE_TENANTS, SERVE_PER_TENANT, SERVE_MAX_LIVE = 4, 128, 64
SERVE_JOBS, SERVE_UNTIL_S = 100, 1800.0
SERVE_POLICY, SERVE_AVG_POLICY = "GreedyP */OPT=MIN", "Greedy */OPT=AVG"
SERVE_SAMPLE = (0, 64)
# (b) phase 4's trace through the CLI's server and client, killed with
# SIGKILL after this sim time
KILL9_UNTIL_S = 20_000.0


def _serve_session(k, i):
    """Tenant k's session i: its name, index (its trace's seed), policy."""
    return (f"s{i}", k * SERVE_PER_TENANT + i,
            SERVE_AVG_POLICY if i == 0 else SERVE_POLICY)


def _quantiles_ms(np, xs):
    a = np.asarray(xs, dtype=np.float64) * 1e3
    return {"n": int(a.size), "p50_ms": float(np.percentile(a, 50)),
            "p99_ms": float(np.percentile(a, 99)), "max_ms": float(a.max())}


def _wire(fields):
    """An outcome dict as the server's JSON carries it (dict keys as
    strings)."""
    return json.loads(json.dumps(fields))


def _wire_result(resp):
    return {k: v for k, v in resp.items()
            if k not in ("id", "ok", "partial", "sim_wall_s", "kind")}


def _host_session(policy, seed, until):
    """The ops of one served session on the port's host numpy session."""
    from repro_torch import api

    ses = api.open_session(N_NODES, policy, alloc_backend="numpy")
    ses.submit(api.parse_workload("lublin", n_jobs=SERVE_JOBS,
                                  n_nodes=N_NODES, seed=seed, load=LOAD))
    ses.step_until(until)
    ses.run_to_exhaustion()
    return _result_fields(ses.result())


def _serve_tenant(port, k, lat, barrier, errors):
    """One tenant's client thread: its sessions one after another (open,
    submit, step_until), parked at the barrier once 64 are held."""
    from repro_torch.serve.client import Client

    try:
        with Client("127.0.0.1", port, tenant=f"t{k}", timeout=900.0) as c:
            for i in range(SERVE_PER_TENANT):
                name, seed, policy = _serve_session(k, i)
                for op, call in (
                        ("open", lambda: c.open(name, policy,
                                                nodes=N_NODES)),
                        ("submit", lambda: c.submit(
                            name, workload="lublin", jobs=SERVE_JOBS,
                            seed=seed, nodes=N_NODES, load=LOAD)),
                        ("step_until", lambda: c.step_until(
                            name, SERVE_UNTIL_S))):
                    t0 = time.perf_counter()
                    call()
                    lat[op].append(time.perf_counter() - t0)
                if i + 1 == SERVE_MAX_LIVE // SERVE_TENANTS:
                    barrier.wait(timeout=900)   # 64 held: memory is read
                    barrier.wait(timeout=900)
    except BaseException as exc:  # noqa: BLE001 — reported by the phase
        errors.append(f"t{k}: {type(exc).__name__}: {exc}")
        barrier.abort()


def _held(torch, reg, base):
    torch.cuda.synchronize()
    return {"sessions_held": reg.n_sessions, "live": reg.n_live,
            "allocated_bytes": torch.cuda.memory_allocated() - base,
            "peak_bytes": torch.cuda.max_memory_allocated() - base}


def serve_tenants(torch, np, tmp):
    """(a) many tenants in process, every session allocating on the card."""
    import threading

    from repro_torch.kernels import ops
    from repro_torch.serve import ServeConfig, ServerThread
    from repro_torch.serve.client import Client

    shapes = Counter()
    solve = ops.maxmin_solve

    def counting(present, weight, active):
        shapes[tuple(weight.shape)] += 1
        return solve(present, weight, active)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    srv = ServerThread(ServeConfig(device="cuda", store=str(Path(tmp) / "a"),
                                   max_live=SERVE_MAX_LIVE,
                                   fsync=False)).start()
    reg = srv.server.registry
    peak_live = [0]
    evict = reg.evict_over_cap

    def watched():                      # runs after every op
        peak_live[0] = max(peak_live[0], reg.n_live)
        return evict()

    reg.evict_over_cap = watched
    ops.maxmin_solve = counting
    errors, mismatches, sample = [], [], []
    lat = {"open": [], "submit": [], "step_until": []}
    try:
        barrier = threading.Barrier(SERVE_TENANTS + 1)
        prof, trace_error = start_device_trace(torch)
        ops.reset_launches()
        t0 = time.perf_counter()
        at_max_live = None
        threads = [threading.Thread(target=_serve_tenant,
                                    args=(srv.port, k, lat, barrier, errors))
                   for k in range(SERVE_TENANTS)]
        for th in threads:
            th.start()
        paused = 0.0
        for _ in range(2):
            try:
                barrier.wait(timeout=900)
            except threading.BrokenBarrierError:
                pass
            if at_max_live is None:
                # the tenants are parked while the memory is read; the
                # pause is not in their wall
                t1 = time.perf_counter()
                at_max_live = _held(torch, reg, base)
                paused = time.perf_counter() - t1
        for th in threads:
            th.join(timeout=1200)
        torch.cuda.synchronize()
        traced = time.perf_counter() - t0
        wall = traced - paused
        t1 = time.perf_counter()
        busy = stop_device_trace(prof, trace_error, traced)
        busy["trace_read_s"] = time.perf_counter() - t1
        at_all = _held(torch, reg, base)
        # the parity sample, through the server: run and result
        for k in range(SERVE_TENANTS):
            with Client("127.0.0.1", srv.port, tenant=f"t{k}",
                        timeout=900.0) as c:
                for i in SERVE_SAMPLE:
                    name, seed, policy = _serve_session(k, i)
                    evicted = not reg.entries[(f"t{k}", name)].live
                    before = reg.n_rehydrations
                    # a new connection: the session's next seq given (its
                    # open, submit and step_until took 0-2)
                    ran = c.call("run", name, seq=3)
                    got = _wire_result(c.result(name))
                    rehydrated = reg.n_rehydrations > before
                    ref = _wire(_host_session(policy, seed, SERVE_UNTIL_S))
                    bad = sorted(f for f in ref if got.get(f) != ref[f])
                    if ran.get("dup"):
                        bad.append("run answered as a duplicate")
                    sample.append({"tenant": f"t{k}", "session": name,
                                   "seed": seed, "policy": policy,
                                   "evicted_before_run": evicted,
                                   "rehydrated_by_run": rehydrated,
                                   "max_stretch": got["max_stretch"],
                                   "mismatched_fields": bad})
                    if bad:
                        mismatches.append(f"t{k}/{name}: {bad[:6]}")
            torch.cuda.synchronize()
        launches = {k: ops.launches[k]
                    for k in ("alloc_matvec", "maxmin_solve", "node_usage")}
        with Client("127.0.0.1", srv.port, tenant="t0") as c:
            stats = c.stats()["registry"]
    except Exception as exc:  # noqa: BLE001 — a failed check, reported
        errors.append(f"{type(exc).__name__}: {exc}")
        launches, stats, wall, busy = {}, {}, 0.0, {}
        at_all = None
    finally:
        ops.maxmin_solve = solve
        srv.stop()
    n_ops = sum(len(v) for v in lat.values())
    return {"tenants": SERVE_TENANTS, "sessions_per_tenant": SERVE_PER_TENANT,
            "max_live": SERVE_MAX_LIVE, "n_nodes": N_NODES,
            "jobs_per_session": SERVE_JOBS, "load": LOAD,
            "until_s": SERVE_UNTIL_S, "policy": SERVE_POLICY,
            "avg_policy": SERVE_AVG_POLICY, "errors": errors,
            "wall_s": wall, "ops": n_ops,
            "ops_per_s": n_ops / wall if wall else None,
            "latency": {op: _quantiles_ms(np, v) for op, v in lat.items()
                        if v},
            "registry": stats, "live_at_peak": peak_live[0],
            "launches": launches,
            "min_shapes": {str(k): v for k, v in shapes.most_common(6)},
            "device": busy, "memory_at_max_live": at_max_live,
            "memory_at_all_held": at_all, "sample": sample,
            "mismatches": mismatches}


def _cli_env():
    """This process's environment with the checkout's ``src`` first on
    the module path."""
    path = [str(ROOT / "src")] + [p for p in [os.environ.get("PYTHONPATH")]
                                  if p]
    return {**os.environ, "PYTHONPATH": os.pathsep.join(path)}


def _repro_torch_cli(args, script=None, timeout=900):
    """``python -m repro_torch <args>`` from the root of this checkout."""
    return subprocess.run([sys.executable, "-m", "repro_torch", *args],
                          input=script, capture_output=True, text=True,
                          timeout=timeout, env=_cli_env(), cwd=str(ROOT))


def _spawn_cli_server(store, port_file, log):
    """``python -m repro_torch serve`` on the card, once it announced its
    port: the process, the port and the seconds it took."""
    t0 = time.perf_counter()
    proc = subprocess.Popen(
        [sys.executable, "-m", "repro_torch", "serve", "--store", store,
         "--port-file", port_file], stdout=log, stderr=subprocess.STDOUT,
        env=_cli_env(), cwd=str(ROOT))
    deadline = time.monotonic() + 300
    while time.monotonic() < deadline:
        if Path(port_file).exists():
            return proc, int(Path(port_file).read_text()), \
                time.perf_counter() - t0
        if proc.poll() is not None:
            raise PhaseFailed(f"the CLI server exited with {proc.returncode} "
                              f"at startup")
        time.sleep(0.1)
    proc.kill()
    proc.wait(timeout=60)
    raise PhaseFailed("the CLI server did not announce a port in 300 s")


def _client_lines(proc):
    if proc.returncode != 0:
        raise PhaseFailed(f"the CLI client exited with {proc.returncode}: "
                          f"{proc.stderr[-2000:]}")
    return [json.loads(line) for line in proc.stdout.splitlines()]


def serve_kill9(tmp, seed0):
    """(b) phase 4's trace through ``python -m repro_torch serve`` (on the
    card) and ``client``, the server killed with SIGKILL, restarted on its
    store and the script re-driven, ``run`` and ``result`` added."""
    import signal

    store, port_file = str(Path(tmp) / "b"), str(Path(tmp) / "b.port")
    script = [
        {"op": "open", "session": "s0", "seq": 0, "policy": SERVE_POLICY,
         "nodes": N_NODES},
        {"op": "submit", "session": "s0", "seq": 1, "workload": "lublin",
         "jobs": N_JOBS, "seed": 0, "nodes": N_NODES, "load": LOAD},
        {"op": "step_until", "session": "s0", "seq": 2, "t": KILL9_UNTIL_S}]
    again = script + [{"op": "run", "session": "s0", "seq": 3},
                      {"op": "result", "session": "s0"}]
    walls, procs = {}, []
    with card_turn(), open(Path(tmp) / "b.log", "w") as log:
        try:
            proc, port, walls["first_start_s"] = _spawn_cli_server(
                store, port_file, log)
            procs.append(proc)
            t0 = time.perf_counter()
            first = _client_lines(_repro_torch_cli(
                ["client", "--port", str(port), "--script", "-"],
                "\n".join(json.dumps(e) for e in script) + "\n"))
            walls["first_drive_s"] = time.perf_counter() - t0
            os.kill(proc.pid, signal.SIGKILL)   # no cleanup, no persist
            proc.wait(timeout=60)
            journal = sum(1 for _ in open(Path(store) / "default"
                                          / "s0.journal"))
            os.unlink(port_file)
            proc, port, walls["second_start_s"] = _spawn_cli_server(
                store, port_file, log)
            procs.append(proc)
            t0 = time.perf_counter()
            second = _client_lines(_repro_torch_cli(
                ["client", "--port", str(port), "--script", "-",
                 "--retry-for", "120"],
                "\n".join(json.dumps(e) for e in again) + "\n"))
            walls["second_drive_s"] = time.perf_counter() - t0
        except PhaseFailed as exc:
            log.flush()
            raise PhaseFailed(f"{exc}\nthe servers' log ends: "
                              f"{(Path(tmp) / 'b.log').read_text()[-3000:]}")
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                p.wait(timeout=60)
    _, host = seed0
    got = _wire_result(second[-1])
    ref = _wire(_result_fields(host))
    bad = sorted(f for f in ref if got.get(f) != ref[f])
    return {"jobs": N_JOBS, "n_nodes": N_NODES, "load": LOAD,
            "policy": SERVE_POLICY, "killed_after_s": KILL9_UNTIL_S,
            "journal_entries_at_kill": journal,
            "first_kinds": [line["kind"] for line in first],
            "first_events": first[-1].get("events"),
            "second_kinds": [line["kind"] for line in second],
            "duplicates": [bool(line.get("dup")) for line in second[:3]],
            "max_stretch": got.get("max_stretch"), "events": got.get("events"),
            "mismatched_fields": bad, **walls}


def serve_cli(seed0):
    """(c) the CLI on the card: ``simulate`` of phase 4's seed-0 cell and
    the tune demo of BENCH_tune.json."""
    record, host = seed0
    t0 = time.perf_counter()
    sim = _repro_torch_cli(["simulate", "--policy", SERVE_POLICY,
                            "--workload", "lublin", "--jobs", str(N_JOBS),
                            "--nodes", str(N_NODES), "--loads", str(LOAD),
                            "--json"])
    sim_wall = time.perf_counter() - t0
    if sim.returncode != 0:
        raise PhaseFailed(f"simulate exited with {sim.returncode}: "
                          f"{sim.stderr[-2000:]}")
    got = json.loads(sim.stdout)
    got.pop("sim_wall_s", None)
    bad_record = [k for k in _OUTCOMES if got[k] != record[k]]
    ref = _wire(_result_fields(host))
    bad_host = sorted(f for f in ref if got.get(f) != ref[f])
    t0 = time.perf_counter()
    tune = _repro_torch_cli([
        "tune", "--policy", TUNE_INCUMBENT, "--spec", TUNE_SPEC,
        "--workload", "lublin", "--jobs", str(TUNE_JOBS), "--nodes",
        str(TUNE_NODES), "--seeds", str(TUNE_SEED), "--loads",
        str(TUNE_LOAD), "--seed", str(TUNER_SEED), "--fail-at",
        str(TUNE_FAIL_T), "--fail-nodes", str(len(TUNE_RACK)), "--join-at",
        str(TUNE_JOIN_T), "--json"])
    tune_wall = time.perf_counter() - t0
    if tune.returncode != 0:
        raise PhaseFailed(f"tune exited with {tune.returncode}: "
                          f"{tune.stderr[-2000:]}")
    out = json.loads(tune.stdout)
    swaps = [{"t": d["t"], "to": d["winner"]["policy"]}
             for d in out["decisions"] if d["swapped"]]
    stretch = out["result"]["max_stretch"]
    return {"simulate": {"wall_s": sim_wall, "max_stretch": got["max_stretch"],
                         "events": got["events"],
                         "record_mismatches": bad_record,
                         "host_mismatches": bad_host},
            "tune": {"wall_s": tune_wall, "races": len(out["decisions"]),
                     "swaps": swaps, "final_policy": out["final_policy"],
                     "max_stretch": stretch,
                     "demo_ok": (len(swaps) == 1 and swaps[0]["t"] == 6000.0
                                 and swaps[0]["to"] == TUNE_PORTFOLIO[1]
                                 and round(stretch, 6)
                                 == TUNE_DEMO_STRETCH)}}


def phase_slice_serve(torch, np, seed0):
    """The multi-tenant session server with its sessions on the card: many
    tenants in process, kill -9 recovery through the CLI's processes, and
    the CLI's simulate and tune."""
    import tempfile

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        tenants = serve_tenants(torch, np, tmp)
        emit({"phase": "slice serve", "part": "tenants", **tenants})
        kill9 = serve_kill9(tmp, seed0)
        emit({"phase": "slice serve", "part": "kill9", **kill9})
    cli = serve_cli(seed0)
    emit({"phase": "slice serve", "part": "cli", **cli})
    held, at64 = tenants["memory_at_all_held"], tenants["memory_at_max_live"]
    launches = tenants["launches"]
    ok = (not tenants["errors"] and not tenants["mismatches"]
          and len(tenants["sample"]) == SERVE_TENANTS * len(SERVE_SAMPLE)
          and any(s["evicted_before_run"] and s["rehydrated_by_run"]
                  for s in tenants["sample"])
          and tenants["registry"].get("sessions")
          == SERVE_TENANTS * SERVE_PER_TENANT
          and tenants["live_at_peak"] <= SERVE_MAX_LIVE + 1
          and launches.get("maxmin_solve", 0) > 0
          and launches.get("alloc_matvec", 0) > 0
          and held is not None and at64 is not None
          and held["allocated_bytes"] <= at64["allocated_bytes"] + 2**20
          and kill9["duplicates"] == [True, True, True]
          and not kill9["mismatched_fields"]
          and not cli["simulate"]["record_mismatches"]
          and not cli["simulate"]["host_mismatches"]
          and cli["tune"]["demo_ok"])
    emit({"phase": "slice serve", "ok": ok,
          "wall_s": time.perf_counter() - t0,
          "parts_wall_s": {"tenants": tenants["wall_s"],
                           "kill9": sum(v for k, v in kill9.items()
                                        if k.endswith("_s")
                                        and k != "killed_after_s"),
                           "simulate": cli["simulate"]["wall_s"],
                           "tune": cli["tune"]["wall_s"]}})
    if not ok:
        raise PhaseFailed("the served sessions disagree with the host run, "
                          "a request failed, device memory grew with the "
                          "sessions held, or a kernel was not reached")
    return launches


# --------------------------------------------------------------------------- #
# the serving path (RecurrentGemma-2B, RWKV6-7B, the dense decoders)           #
# --------------------------------------------------------------------------- #
RG, RWKV, LLAMA = "recurrentgemma-2b", "rwkv6-7b", "llama3-8b"
QWEN_MOE, DEEPSEEK = "qwen2-moe-a2.7b", "deepseek-v3-671b"
WHISPER, INTERNVL = "whisper-large-v3", "internvl2-76b"
# the instance each kernel must take in a served prefill and decode
# (ops.routes): bf16 attention on the tensor cores, attn_wgmma_kernel<NVP>
# with NVP = hdv / 64 and decode_mma_kernel<TQ, 1> for groups up to 16; the
# recurrences chunked in prefill, sequential in decode (the RG-LRU's decode
# on its gated route, the gates fused in)
_RECURRENT_ROUTES = {"prefill": "chunked", "decode": "sequential"}
# per arch: the kernels its path launches and their instances, the model
# check's depth, prompt and weight seed (and its cache types), the serve's
# new tokens a request and its seed, and the serve's cuts for the script's
# time limit: RecurrentGemma-2B, RWKV6-7B and Llama-3-8B at half depth
# (their full-depth serves are in PERF.md), the MoE family in requests
SERVE_ARCHS = {
    RG: {"kernels": ("flash_attention", "flash_decode", "rglru_scan"),
         "routes": {"flash_attention": {"prefill": "wgmma<4>"},
                    "flash_decode": {"decode": "mma<1>"},
                    "rglru_scan": {"prefill": "chunked",
                                   "decode": "gated"}},
         "check_layers": 3, "check_prompt": 2100, "check_seed": 2402,
         # three of seed 60's eight prompts decode past the 2,048 window
         "max_new": 96, "seed": 60, "serve_layers": 13},
    RWKV: {"kernels": ("wkv6",), "routes": {"wkv6": _RECURRENT_ROUTES},
           "check_layers": 2, "check_prompt": 1000, "check_seed": 2404,
           "max_new": 64, "seed": 64, "serve_layers": 16},
    # full causal GQA (32 query heads over 8, head dim 128) over a cache
    # that is not a ring; its model check runs again on an int8 cache
    LLAMA: {"kernels": ("flash_attention", "flash_decode"),
            "routes": {"flash_attention": {"prefill": "wgmma<2>"},
                       "flash_decode": {"decode": "mma<1>"}},
            "check_layers": 2, "check_prompt": 512, "check_seed": 2407,
            "check_caches": ("float32", "int8"),
            "max_new": 64, "seed": 80, "serve_layers": 16},
    # multi-head (16 query heads over 16, head dim 128: a decode group of
    # one), 60 routed experts top-4 and 4 gated shared ones in every layer;
    # at full width and depth, one wave of 4 requests (the script's time
    # limit)
    QWEN_MOE: {"kernels": ("flash_attention", "flash_decode"),
               "routes": {"flash_attention": {"prefill": "wgmma<2>"},
                          "flash_decode": {"decode": "mma<1>"}},
               "check_layers": 2, "check_prompt": 512, "check_seed": 2413,
               "requests": 4, "max_new": 64, "seed": 90},
    # MLA: prefill attention at qk head dim 192 over v head dim 128 (its
    # decode is latent einsums, no kernel); cut to 4 layers (the 3 dense
    # ones and a MoE layer of 256 experts top-8), one wave of 4 requests of
    # 16 new tokens; the MTP depth, a training head that serving never
    # runs, left out
    DEEPSEEK: {"kernels": ("flash_attention",),
               "routes": {"flash_attention": {"prefill": "wgmma<2>"}},
               "cut": {"mtp": False},
               "check_layers": 2, "check_prompt": 512, "check_seed": 2414,
               "serve_layers": 4, "requests": 4, "max_new": 16,
               "seed": 91},
    # the encoder-decoder at full size (32 + 32 layers, 20 heads over 20
    # of 64: prefill attention on wgmma<1>, a decode group of one), served
    # as its users run it: a request's 1,500 encoder frames (30 s of audio)
    # encoded, then its prompt prefilled into its slot with the frames'
    # cross K/V, then decode over the 4 slots; prompts of 64-384 tokens,
    # a cache of 512; its model check 2 + 2 layers deep with a 256-token
    # prompt
    WHISPER: {"kernels": ("flash_attention", "flash_decode"),
              "routes": {"flash_attention": {"prefill": "wgmma<1>"},
                         "flash_decode": {"decode": "mma<1>"}},
              "frames": 1500, "check_cut": {"encoder_layers": 2},
              "check_layers": 2, "check_prompt": 256, "check_seed": 2416,
              "cache_len": 512, "prompt_range": (64, 385),
              "max_new": 64, "seed": 92},
    # the vision stub at full width (64 query heads over 8 of 128: wgmma<2>
    # and a decode group of 8 on mma<1>), cut to 8 of its 80 layers (the
    # whole model, about 141 GB in bf16, does not fit one card); each
    # request's first 256 token embeddings replaced by 256 seeded patch
    # embeddings; one wave of 4 requests of 1,024-2,000 tokens in all, 32
    # new tokens; its model check 2 layers deep, 256 patches + 256 tokens
    INTERNVL: {"kernels": ("flash_attention", "flash_decode"),
               "routes": {"flash_attention": {"prefill": "wgmma<2>"},
                          "flash_decode": {"decode": "mma<1>"}},
               "patches": 256, "check_layers": 2, "check_prompt": 512,
               "check_seed": 2417, "serve_layers": 8, "requests": 4,
               "max_new": 32, "seed": 93},
}
# the other dense decoders: model checks only (full width, 2 layers), for
# qk_norm (Qwen3-8B), a group of 3 at head dim 64 (SmolLM-360M) and tied
# embeddings over a 49,155 vocabulary (Granite-3-2B)
_DENSE_CHECK = {"kernels": ("flash_attention", "flash_decode"),
                "check_layers": 2, "check_prompt": 512}
CHECK_ARCHS = {"qwen3-8b": dict(_DENSE_CHECK, check_seed=2505),
               "smollm-360m": dict(_DENSE_CHECK, check_seed=2406),
               "granite-3-2b": dict(_DENSE_CHECK, check_seed=2410)}
# the block kinds of the layers that call each kernel (models/config.py)
_KINDS = {"flash_attention": ("attn", "local", "mla"),
          "flash_decode": ("attn", "local"),
          "rglru_scan": ("rglru",), "wkv6": ("rwkv6",)}
TOL = {"float32": 2e-5, "bfloat16": 2e-2}      # the reference's kernel tests
RGLRU_ATOL, RGLRU_RTOL = 1e-5, 1e-4
WKV_TOL = 1e-4                                 # atol = rtol
MODEL_TOL = 2e-3                               # the reference's model tests
# a routing flip between card and host passes only on a near-tie: the
# host's k-th and (k+1)-th router probabilities closer than this
FLIP_MARGIN = 1e-6
CHECK_STEPS, CHECK_CACHE = 8, 4096
SERVE_SLOTS, SERVE_CACHE, SERVE_REQUESTS = 4, 4096, 8
# the traced replay of a serve's last wave: its prompts, at most this many
# new tokens a request (the script's time limit; the serve before it runs
# every token)
REPLAY_NEW = 16


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


def sdpa_backend(torch, *args, **kw):
    """The backend SDPA's dispatcher picks for these arguments (its
    chooser, ``torch._fused_sdp_choice``), and the backends that accept
    them when forced one at a time: what ran as the library call."""
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    chooser = getattr(torch, "_fused_sdp_choice", None)
    try:
        picked = SDPBackend(chooser(*args, **kw)).name if chooser else None
    except (RuntimeError, TypeError, ValueError) as exc:
        picked = f"unknown ({type(exc).__name__})"
    accepting = []
    for b in (SDPBackend.FLASH_ATTENTION, SDPBackend.EFFICIENT_ATTENTION,
              SDPBackend.CUDNN_ATTENTION, SDPBackend.MATH):
        try:
            with sdpa_kernel([b]):
                F.scaled_dot_product_attention(*args, **kw)
            accepting.append(b.name)
        except RuntimeError:
            pass
    torch.cuda.synchronize()
    return {"library_backend": picked, "library_backends_accepting":
            accepting}


def prefill_check(torch, gen, dt, case, scale=None, timed=False,
                  kv_dt=None):
    """One flash attention case against the plain version, with its route
    and instance; ``timed``: also device ms of the kernel and of SDPA on
    the same inputs, with SDPA's backend.  case: (label, B, Tq, Tk, H,
    Hkv, hd, hdv, causal, window, q_offset); k and v have type ``kv_dt``
    (``dt`` when None), and a mixed call is held to bf16's tolerance."""
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import (
        attention_instance, attention_route, flash_attention_cuda,
        flash_attention_plain)
    label, B, Tq, Tk, H, Hkv, hd, hdv, causal, window, off = case
    kv_dt = dt if kv_dt is None else kv_dt
    name = _dtype_name(torch, dt)
    tol = TOL[_dtype_name(torch, kv_dt)] if kv_dt != dt else TOL[name]
    if kv_dt != dt:
        name += "+" + _dtype_name(torch, kv_dt)
    q = _randn(torch, gen, (B, Tq, H, hd), dt)
    k = _randn(torch, gen, (B, Tk, Hkv, hd), kv_dt)
    v = _randn(torch, gen, (B, Tk, Hkv, hdv), kv_dt)
    kw = dict(causal=causal, window=window, q_offset=off, scale=scale)
    got = flash_attention_cuda(q, k, v, **kw)
    want = flash_attention_plain(q, k, v, **kw)
    torch.cuda.synchronize()
    out = {"kernel": "flash_attention", "case": label, "dtype": name,
           "route": attention_route(q, k, v),
           "instance": attention_instance(q, k, v),
           "shape": [B, Tq, Tk, H, Hkv, hd, hdv], "causal": causal,
           "window": window, "q_offset": off, "scale": scale,
           "max_abs_err": _err(got, want),
           "ok": got.dtype == dt and _within(torch, got, want, tol, tol)}
    if timed:                  # causal, no window, no offset: SDPA's case
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        sdpa_kw = dict(is_causal=causal, scale=scale, enable_gqa=H != Hkv)
        out.update(
            ms=device_ms(torch, lambda: flash_attention_cuda(q, k, v, **kw),
                         20),
            library="F.scaled_dot_product_attention",
            **sdpa_backend(torch, qt, kt, vt, **sdpa_kw))
        out["library_ms"] = (device_ms(
            torch, lambda: F.scaled_dot_product_attention(qt, kt, vt,
                                                          **sdpa_kw), 20)
            if out["library_backends_accepting"] else None)
    return out


def decode_check(torch, gen, dt, case, timed=False):
    """One flash decode case against the plain version, with its route
    and instance; ``timed``: also device ms of the kernel and of SDPA (the
    valid slots as a mask) on the same inputs, with SDPA's backend.
    case: (label, B, S, H, Hkv, hd, hdv, q dtype, lengths); the cache has
    type ``dt``."""
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import (
        decode_instance, decode_route, flash_decode_cuda, flash_decode_plain)
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
    out = {"kernel": "flash_decode", "case": label,
           "dtype": [_dtype_name(torch, qdt), name],
           "route": decode_route(q, k, v),
           "instance": decode_instance(q, k, v),
           "shape": [B, S, H, Hkv, hd, hdv], "lens": lens,
           "max_abs_err": _err(got, want),
           "ok": got.dtype == qdt and _within(torch, got, want, tol, tol)}
    if S == 0:                 # no key: exactly 0, and so is the plain one
        out["ok"] = out["ok"] and not got.any() and not want.any()
    if timed and qdt == dt:
        valid = torch.clamp(cur + 1, max=S)
        mask = (torch.arange(S, device="cuda")[None, :]
                < valid[:, None])[:, None, None, :]
        qd, kd, vd = q[:, :, None], k.transpose(1, 2), v.transpose(1, 2)
        sdpa_kw = dict(attn_mask=mask, enable_gqa=H != Hkv)
        out.update(
            ms=device_ms(torch, lambda: flash_decode_cuda(q, k, v, cur),
                         200),
            library="F.scaled_dot_product_attention",
            **sdpa_backend(torch, qd, kd, vd, **sdpa_kw))
        out["library_ms"] = (device_ms(
            torch, lambda: F.scaled_dot_product_attention(qd, kd, vd,
                                                          **sdpa_kw), 200)
            if out["library_backends_accepting"] else None)
    return out


def phase_serve_kernels(torch):
    from repro_torch.kernels import rglru_scan as rglru
    from repro_torch.kernels import rwkv6_scan as rwkv

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
             0),
            # SmolLM-360M: a group of 3 at head dim 64 (attn_wgmma_kernel<1>)
            ("smollm_360m_g3", 4, 2048, 2048, 15, 5, 64, 64, True, 0, 0)]:
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
             list(range(0, 640, 10))),
            # SmolLM-360M: a group of 3 at head dim 64 on the mma route
            ("smollm_360m_g3", 4, 2048, 15, 5, 64, 64, bf,
             [0, 1000, 2047, 3000])]:
        checks.append(decode_check(torch, gen, bf, case))
    # the MoE family's shapes, fp32 and bf16 (bf16 on the instances its
    # serves take), each timed beside SDPA: DeepSeek-V3's MLA prefill (qk
    # head dim 192 over v head dim 128, scale 1/sqrt(192): wgmma<2> with
    # three Q/K panels against two V panels), Qwen1.5-MoE's prefill (16
    # over 16 at head dim 128: wgmma<2>) and its decode (a group of one:
    # mma<1>, 15 of a tile's 16 rows masked; lengths 0, S - 1 and past S)
    for dt in (torch.float32, bf):
        checks.append(prefill_check(
            torch, gen, dt, ("mla_hd192_hdv128", 1, 1024, 1024, 128, 128,
                             192, 128, True, 0, 0),
            scale=1.0 / 192 ** 0.5, timed=True))
        checks.append(prefill_check(
            torch, gen, dt, ("qwen2_moe_prefill", 1, 1540, 1540, 16, 16, 128,
                             128, True, 0, 0), timed=True))
        checks.append(decode_check(
            torch, gen, dt, ("qwen2_moe_decode_g1", 4, 4096, 16, 16, 128,
                             128, dt, [0, 1537, 4095, 5000]), timed=True))
    # Whisper's (20 over 20 heads of 64) and InternVL2's (64 over 8 of
    # 128), fp32 and bf16, each timed beside SDPA: the encoder's 1,500
    # frames (bidirectional), a decoder prompt (causal), cross-attention
    # prefill (non-causal, 300 queries against 1,500 frames: both ragged
    # against a 64-key tile), decode over a 512-slot cache and over the
    # 1,500 cross frames (cur_len = S_enc), and InternVL2's prefill of
    # 1,500 tokens and decode over 4,096 slots; then a decode over an empty
    # cache (S = 0, the mirrored server's cross cache), which must give 0
    # the CUDA-core instance keeps what neither tensor-core one takes (an
    # fp32 q over bf16 k and v; fp32 at hd 60, no multiple of 8); rows the
    # masks leave with no key (q_offset < 0) attend to every key with equal
    # weight, as in the reference, on all three instances
    for dt, kv_dt, case in [
            (torch.float32, bf, ("mixed_fp32_q_bf16_kv", 2, 300, 300, 8, 2,
                                 64, 64, True, 0, 0)),
            (torch.float32, None, ("fp32_hd60", 1, 200, 200, 4, 1, 60, 60,
                                   True, 0, 0)),
            (torch.float32, None, ("rows_with_no_key", 2, 150, 150, 4, 2, 64,
                                   64, True, 0, -70)),
            (bf, None, ("rows_with_no_key", 2, 150, 150, 4, 2, 64, 64, True,
                        0, -70)),
            (torch.float32, bf, ("rows_with_no_key", 2, 150, 150, 4, 2, 64,
                                 64, True, 0, -70))]:
        checks.append(prefill_check(torch, gen, dt, case, kv_dt=kv_dt))
    for dt in (torch.float32, bf):
        for case in [
                ("whisper_encoder", 1, 1500, 1500, 20, 20, 64, 64, False, 0,
                 0),
                ("whisper_decoder_prompt", 1, 384, 384, 20, 20, 64, 64,
                 True, 0, 0),
                ("whisper_cross_prefill", 1, 300, 1500, 20, 20, 64, 64,
                 False, 0, 0),
                ("internvl2_prefill", 1, 1500, 1500, 64, 8, 128, 128, True,
                 0, 0)]:
            checks.append(prefill_check(torch, gen, dt, case, timed=True))
        for case in [
                ("whisper_decode_g1", 4, 512, 20, 20, 64, 64, dt,
                 [0, 200, 447, 600]),
                ("whisper_cross_decode", 4, 1500, 20, 20, 64, 64, dt,
                 [1500] * 4),
                ("internvl2_decode_g8", 4, 4096, 64, 8, 128, 128, dt,
                 [1000, 1600, 2047, 5000])]:
            checks.append(decode_check(torch, gen, dt, case, timed=True))
        for qdt in (dt, torch.float32):
            checks.append(decode_check(
                torch, gen, dt, ("empty_cache", 4, 0, 20, 20, 64, 64, qdt,
                                 [0] * 4)))
    want = {("mla_hd192_hdv128", "bfloat16"): "wgmma<2>",
            ("qwen2_moe_prefill", "bfloat16"): "wgmma<2>",
            ("qwen2_moe_decode_g1", "bfloat16"): "mma<1>",
            ("whisper_encoder", "bfloat16"): "wgmma<1>",
            ("whisper_decoder_prompt", "bfloat16"): "wgmma<1>",
            ("whisper_cross_prefill", "bfloat16"): "wgmma<1>",
            ("internvl2_prefill", "bfloat16"): "wgmma<2>",
            ("whisper_decode_g1", "bfloat16"): "mma<1>",
            ("whisper_cross_decode", "bfloat16"): "mma<1>",
            ("internvl2_decode_g8", "bfloat16"): "mma<1>",
            ("empty_cache", "bfloat16"): "mma<1>"}
    # every fp32 prefill case on the 3xTF32 instance, but those that take
    # the CUDA-core one
    cuda_cores = {("mixed_fp32_q_bf16_kv", "float32+bfloat16"),
                  ("fp32_hd60", "float32"),
                  ("rows_with_no_key", "float32+bfloat16")}
    for c in checks:
        dt_name = c["dtype"] if c["kernel"] == "flash_attention" \
            else c["dtype"][1]
        if (c.get("case"), dt_name) in want:
            c["ok"] = c["ok"] and c["instance"] == want[(c["case"], dt_name)]
        if c["kernel"] == "flash_attention" and dt_name.startswith("float32"):
            route = ("cuda_cores" if (c["case"], dt_name) in cuda_cores
                     else "tf32x3")
            c["ok"] = c["ok"] and c["route"] == route and (
                route != "tf32x3" or c["max_abs_err"] <= TOL["float32"])
    # (B, T, W, route: None for the one rglru_route picks)
    rt = rglru.CHUNKED_MIN_T
    for B, T, W, route in [
            (4, 1, 2560, None), (1, 2100, 2560, None),
            (1, 2100, 2560, "sequential"), (2, 37, 100, None),
            (2, 37, 100, "chunked"), (2, 20, 100, "chunked"),
            (1, rt - 1, 2560, None), (1, rt, 2560, None),
            (2, 0, 64, "chunked")]:
        a = torch.sigmoid(_randn(torch, gen, (B, T, W), torch.float32)) * 0.9
        b = _randn(torch, gen, (B, T, W), torch.float32)
        h0 = _randn(torch, gen, (B, W), torch.float32)
        taken = route or rglru.rglru_route(B, T, W)
        h, hT = rglru.rglru_scan_cuda(a, b, h0, route=route)
        hp, hTp = rglru.linear_recurrence_plain(a, b, h0)
        hc, hTc = rglru.linear_recurrence_chunked_plain(a, b, h0)
        torch.cuda.synchronize()
        bit_equal = bool(torch.equal(h, hp) and torch.equal(hT, hTp))
        chunked_equal = bool(torch.equal(h, hc) and torch.equal(hT, hTc))
        checks.append({"kernel": "rglru_scan", "shape": [B, T, W],
                       "route": taken,
                       "max_abs_err": max(_err(h, hp), _err(hT, hTp)),
                       "bit_equal": bit_equal,
                       "bit_equal_chunked_plain": chunked_equal,
                       # sequential: bit for bit; chunked: the reference's
                       # tolerance, and bit for bit against its algorithm
                       "ok": _within(torch, h, hp, RGLRU_ATOL, RGLRU_RTOL)
                       and _within(torch, hT, hTp, RGLRU_ATOL, RGLRU_RTOL)
                       and (bit_equal if taken == "sequential"
                            else chunked_equal)})
    checks += rglru_gated_checks(torch, gen)
    # (label, B, T, H, dk, dv, r/k/v dtype, lowest decay, route: None for
    # the one wkv6_route picks)
    wt = rwkv.CHUNKED_MIN_T
    for label, B, T, H, dk, dv, dt, w_low, route in [
            ("rwkv6_decode", 4, 1, 64, 64, 64, torch.bfloat16, 0.9, None),
            ("rwkv6_prefill", 1, 2000, 64, 64, 64, torch.bfloat16, 0.9, None),
            ("rwkv6_prefill", 1, 2000, 64, 64, 64, torch.float32, 0.9, None),
            ("rwkv6_prefill", 1, 2000, 64, 64, 64, torch.bfloat16, 0.9,
             "sequential"),
            ("ragged", 2, 37, 3, 32, 48, torch.float32, 0.45, None),
            ("ragged_short", 2, 37, 3, 32, 48, torch.float32, 0.45,
             "chunked"),
            ("ragged_long", 2, 100, 3, 32, 48, torch.bfloat16, 0.45, None),
            ("below_threshold", 1, wt - 1, 64, 64, 64, torch.bfloat16, 0.9,
             None),
            ("at_threshold", 1, wt, 64, 64, 64, torch.bfloat16, 0.9, None),
            ("strong_decay", 1, 2000, 64, 64, 64, torch.float32, 1e-3, None),
            ("strong_decay", 1, 2000, 64, 64, 64, torch.float32, 1e-3,
             "sequential"),
            ("decay_1e-6", 1, 2000, 64, 64, 64, torch.float32, 1e-6, None),
            ("decay_1e-6", 1, 2000, 64, 64, 64, torch.bfloat16, 1e-6,
             None)]:
        args = wkv6_inputs(torch, gen, B, T, H, dk, dv, dt, w_low)
        taken = route or rwkv.wkv6_route(B, T, H, dk, dv)
        y, sT = rwkv.wkv6_cuda(*args, route=route)
        yp, sTp = rwkv.wkv6_plain(*args)
        state = args[5].clone()              # a serving slot's state
        y2, _ = rwkv.wkv6_cuda(*args[:5], state, state_out=state,
                               route=route)
        torch.cuda.synchronize()
        finite = bool(torch.isfinite(y).all() and torch.isfinite(sT).all())
        checks.append({"kernel": "wkv6", "case": label, "route": taken,
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
    routes = {k: {c["route"] for c in checks if c["kernel"] == k}
              for k in ("rglru_scan", "wkv6")}
    ok = all(c["ok"] for c in checks) and routes == {
        "rglru_scan": {"sequential", "chunked", "gated"},
        "wkv6": {"sequential", "chunked"}}
    emit({"phase": "serve kernels", "ok": ok,
          "tolerance": {"float32": TOL["float32"], "bfloat16": TOL["bfloat16"],
                        "rglru_scan": [RGLRU_ATOL, RGLRU_RTOL],
                        "wkv6": [WKV_TOL, WKV_TOL]},
          "checks": checks})
    if not ok:
        raise PhaseFailed("a serving kernel disagrees with its plain version "
                          "or a route of a recurrence went unchecked")


def gated_inputs(torch, gen, B, T, W, dtype):
    """The RG-LRU's gated route's inputs: the conv output and the two
    block-diagonal products before their biases (B, T, W), the biases and
    lam (W,), all in ``dtype``, and h0 (B, W) fp32; the products wide
    enough to saturate the sigmoids, lam of both signs."""
    xs = [_randn(torch, gen, (B, T, W), dtype) * s for s in (1.0, 3.0, 3.0)]
    ws = [_randn(torch, gen, (W,), dtype) * s for s in (0.5, 0.5, 2.0)]
    return (*xs, *ws, _randn(torch, gen, (B, W), torch.float32))


def rglru_gated_checks(torch, gen):
    """The RG-LRU's gated route (the gate chain fused into the recurrence)
    against the chain run operator by operator on the card, bf16 and fp32:
    a RecurrentGemma-2B decode step (4 slots x 2,560), T one short of the
    chunked route's threshold, a ragged width, T = 0; hT written over h0 as
    a serving slot's state; and one differentiable call through ``ops``
    (kernel forward, the plain chain's backward) against autograd of the
    plain chain.  Held to the recurrence's tolerance, bit equality
    reported."""
    from repro_torch.kernels import ops
    from repro_torch.kernels import rglru_scan as rglru

    bf, f32 = torch.bfloat16, torch.float32
    rt = rglru.CHUNKED_MIN_T
    checks = []
    for B, T, W, dt in [(4, 1, 2560, bf), (4, 1, 2560, f32),
                        (1, rt - 1, 2560, bf), (2, 37, 100, bf),
                        (3, 5, 64, f32), (2, 0, 64, bf)]:
        args = gated_inputs(torch, gen, B, T, W, dt)
        h, hT = rglru.rglru_gated_cuda(*args)
        hp, hTp = rglru.rglru_gated_plain(*args)
        state = args[-1].clone()                 # a serving slot's state
        h2, hT2 = rglru.rglru_gated_cuda(*args[:-1], state, state_out=state)
        torch.cuda.synchronize()
        in_place = bool(hT2 is state and torch.equal(h2, h)
                        and torch.equal(state, hT))
        checks.append({"kernel": "rglru_scan", "route": "gated",
                       "dtype": _dtype_name(torch, dt), "shape": [B, T, W],
                       "max_abs_err": max(_err(h, hp), _err(hT, hTp)),
                       "bit_equal": bool(torch.equal(h, hp)
                                         and torch.equal(hT, hTp)),
                       "in_place_equal": in_place,
                       "ok": in_place
                       and _within(torch, h, hp, RGLRU_ATOL, RGLRU_RTOL)
                       and _within(torch, hT, hTp, RGLRU_ATOL, RGLRU_RTOL)})
    leaves = [t.requires_grad_() for t in gated_inputs(torch, gen, 2, 3, 64,
                                                       f32)]
    seed = torch.randn((2, 3, 64), generator=gen, device="cuda")
    grads = []
    for fn in (ops.rglru_gated, rglru.rglru_gated_plain):
        h, hT = fn(*leaves)
        grads.append(torch.autograd.grad((h * seed).sum() + hT.sum(),
                                         leaves))
    err = max(_err(g, w) for g, w in zip(*grads))
    checks.append({"kernel": "rglru_scan", "route": "gated",
                   "case": "gradients", "dtype": "float32",
                   "shape": [2, 3, 64], "max_abs_err": err,
                   "bit_equal": all(torch.equal(g, w)
                                    for g, w in zip(*grads)),
                   "ok": all(_within(torch, g, w, RGLRU_ATOL, RGLRU_RTOL)
                             for g, w in zip(*grads))})
    return checks


def phase_model_check(torch, np, arch, spec):
    """``arch`` at full width, cut to ``spec["check_layers"]``, fp32
    weights drawn on the card from the check's seed and copied to the host:
    a prefill of ``check_prompt`` tokens and CHECK_STEPS decode steps on the
    card (kernels) and on the host CPU (plain versions), the host's greedy
    picks fed to both, logits compared; once a cache type of
    ``check_caches`` (an int8 cache: the quantized KV layout on both
    sides), one line each.  ``spec["cut"]`` and ``spec["check_cut"]``
    change more of the config (DeepSeek-V3: no MTP depth; Whisper: 2
    encoder layers).  An encoder-decoder encodes ``spec["frames"]`` seeded
    frame embeddings (0.02 x normal) into a cross cache of as many frames;
    a vision config's first ``spec["patches"]`` tokens take seeded patch
    embeddings.  Where the cut has MoE layers, each
    side's routing is recorded (:class:`routing_recorder`) and compared
    (:func:`routing_report`): a routing flip passes only on a near-tie of
    the host, and the logits are held to the tolerance at every step
    before the first flip."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.models import backbone
    from repro_torch.models.config import MOE, layer_plan

    cfg = dataclasses.replace(get_config(arch), n_layers=spec["check_layers"],
                              **spec.get("cut", {}),
                              **spec.get("check_cut", {}))
    n_moe = sum(b.mlp == MOE for b in layer_plan(cfg))
    n_prompt = spec["check_prompt"]
    extras = frontend_inputs(torch, np, spec, cfg, spec["check_seed"])
    gen = torch.Generator(device="cuda")
    gen.manual_seed(spec["check_seed"])
    t0 = time.perf_counter()
    card = backbone.init_params(cfg, gen, dtype=torch.float32, device="cuda")
    host = _tree_map(lambda t: t.cpu(), card)
    init_s = time.perf_counter() - t0
    prompt = torch.as_tensor(np.random.default_rng(spec["check_seed"])
                             .integers(1, cfg.vocab, size=(1, n_prompt)))
    cache_types = {"float32": torch.float32, "int8": torch.int8}

    def run(params, device, cache_dtype, feed=None):
        """Prefill, then decode the tokens of ``feed`` (when None, the run's
        own greedy picks).  Returns the logits of every step on the host,
        the tokens fed, the seconds taken and the routing of each MoE
        call."""
        caches = backbone.init_cache(cfg, 1, CHECK_CACHE,
                                     S_enc=spec.get("frames", 0),
                                     dtype=cache_dtype, device=device)
        batch = {"tokens": prompt.to(device),
                 **{k: v.to(device) for k, v in extras.items()}}
        with routing_recorder(torch) as routing:
            t = time.perf_counter()
            logits, caches = backbone.prefill(cfg, params, batch, caches)
            out, fed = [logits.float().cpu()], []
            for i in range(CHECK_STEPS):
                tok = (feed[i] if feed is not None
                       else torch.argmax(out[-1], -1))
                fed.append(tok)
                logits, caches = backbone.decode_step(
                    cfg, params, tok.to(device), caches, n_prompt + i)
                out.append(logits.float().cpu())
            seconds = time.perf_counter() - t
        return out, fed, seconds, routing

    for cache_name in spec.get("check_caches", ("float32",)):
        cache_dtype = cache_types[cache_name]
        host_logits, feed, host_s, host_routing = run(host, "cpu",
                                                      cache_dtype)
        ops.reset_launches()
        card_logits, _, card_s, card_routing = run(card, "cuda", cache_dtype,
                                                   feed)
        launches = {k: ops.launches[k] for k in spec["kernels"]}
        routes = {k: dict(ops.routes[k]) for k in spec["kernels"]}
        diffs = [float((c - h).abs().max())
                 for c, h in zip(card_logits, host_logits)]
        routing = routing_report(host_routing, card_routing, n_moe)
        # every step when the routing agrees throughout, else every step
        # before the first flip (the caches carry it into the later ones)
        held = routing["first_flip_step"] if routing["flips"] else None
        within = all(bool(((c - h).abs() <= MODEL_TOL + MODEL_TOL
                           * h.abs()).all())
                     for c, h in zip(card_logits[:held], host_logits[:held]))
        agree = sum(int(torch.argmax(c)) == int(torch.argmax(h))
                    for c, h in zip(card_logits, host_logits))
        finite = all(bool(torch.isfinite(c).all()) for c in card_logits)
        ok = (within and finite and routing["ok"]
              and all(v > 0 for v in launches.values()))
        emit({"phase": "model check", "ok": ok, "arch": arch,
              "layers": cfg.n_layers, "d_model": cfg.d_model,
              "encoder_layers": cfg.encoder_layers,
              "frames": spec.get("frames", 0),
              "patches": spec.get("patches", 0),
              "heads": [cfg.n_heads, cfg.n_kv_heads, cfg.head_dim],
              "vocab": cfg.vocab, "qk_norm": cfg.qk_norm,
              "tie_embeddings": cfg.tie_embeddings, "dtype": "float32",
              "cache_dtype": cache_name, "prompt": n_prompt,
              "decode_steps": CHECK_STEPS, "cache_len": CHECK_CACHE,
              "window": cfg.window,
              "tolerance": {"atol": MODEL_TOL, "rtol": MODEL_TOL},
              "max_abs_logit_diff": diffs, "greedy_agree": agree,
              "greedy_total": len(card_logits), "launches": launches,
              "routes": routes, "moe_layers": n_moe,
              "experts": [cfg.n_experts, cfg.top_k, cfg.capacity_factor],
              "routing": routing,
              "params": sum(t.numel() for t in _leaves(card)),
              "init_s": init_s, "host_s": host_s, "card_s": card_s})
        if not ok:
            raise PhaseFailed(f"the card's logits disagree with the host's "
                              f"({arch}, {cache_name} cache)")
    del host, card
    torch.cuda.empty_cache()


def frontend_inputs(torch, np, spec, cfg, seed, batch=1):
    """The stub frontends' inputs of one batch, on the host, drawn with
    numpy from ``seed`` (0.02 x normal, as the data source draws them):
    ``enc_embeds`` of ``spec["frames"]`` frames for an encoder-decoder,
    ``vision_embeds`` of ``spec["patches"]`` patches for a vision
    config."""
    rng = np.random.default_rng([seed, 1])
    out = {}
    if cfg.is_encdec:
        out["enc_embeds"] = 0.02 * rng.standard_normal(
            (batch, spec["frames"], cfg.d_model))
    if cfg.frontend == "vision":
        out["vision_embeds"] = 0.02 * rng.standard_normal(
            (batch, spec["patches"], cfg.d_model))
    return {k: torch.as_tensor(v, dtype=torch.float32)
            for k, v in out.items()}


class routing_recorder:
    """Within its block, ``repro_torch.models.moe.moe_apply`` (the backbone
    calls it through the module) records each call's routing before it
    runs: every token's top-k experts, sorted, and the margin between its
    k-th and (k+1)-th router probabilities, on the host.  The router runs
    once more for this, the same operations on the same inputs."""

    def __init__(self, torch):
        from repro_torch.models import moe
        self.torch, self.moe, self.calls = torch, moe, []

    def __enter__(self):
        torch, moe, calls = self.torch, self.moe, self.calls
        self.apply = apply = moe.moe_apply

        def recorded(cfg, p, x):
            with torch.no_grad():       # outside a training step's graph
                _, _, probs = moe.router_probs(cfg, p, x)
                k = cfg.top_k
                top = torch.topk(probs, k + 1, dim=-1)
                calls.append((top.indices[:, :k].sort(dim=-1).values.cpu(),
                              (top.values[:, k - 1]
                               - top.values[:, k]).cpu()))
            return apply(cfg, p, x)
        moe.moe_apply = recorded
        return calls

    def __exit__(self, *exc):
        self.moe.moe_apply = self.apply


def routing_report(host, card, n_moe, where=None):
    """Both sides' routing (:class:`routing_recorder`), call by call in
    order: the assignments that differ, by layer, and the host's margin at
    each.  ``where(i)`` is call i's (step, layer); by default a step's MoE
    layers in order, step after step (the prefill is step 0).
    Flips at the first call that has any arise from near-ties only (that
    call's inputs agree within the check's tolerance), so they pass when
    the host's margin is below FLIP_MARGIN at every one; later ones follow
    from them (an expert changed, capacity taken from another token, the
    caches written) and are reported."""
    where = where or (lambda i: divmod(i, n_moe))
    flips, margins, by_layer, first = 0, [], [0] * n_moe, None
    for i, ((h_idx, h_margin), (c_idx, _)) in enumerate(zip(host, card)):
        bad = (h_idx != c_idx).any(-1)
        n = int(bad.sum())
        if not n:
            continue
        step, layer = where(i)
        flips += n
        by_layer[layer] += n
        margins += h_margin[bad].tolist()
        if first is None:
            first = {"call": i, "step": step, "layer": layer,
                     "tokens": n, "host_margins": h_margin[bad].tolist()}
    ok = len(host) == len(card) and (
        first is None or max(first["host_margins"]) < FLIP_MARGIN)
    return {"ok": ok, "calls": len(host),
            "assignments": sum(int(h[0].shape[0]) for h in host),
            "flips": flips, "flips_by_layer": by_layer,
            "first_flip_step": first["step"] if first else None,
            "first_flip": first,
            "smallest_host_margin_of_flips": min(margins) if margins
            else None,
            "smallest_host_margin": min(
                (float(h[1].min()) for h in host), default=None),
            "flip_margin": FLIP_MARGIN}


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
    from repro_torch.models.config import layer_plan
    from repro_torch.train.serve import BatchedServer, Request, ServeConfig

    class TimedServer(BatchedServer):
        """The server, with each prefill and decode step synchronised and
        timed, and its logits checked for finite values.  With
        ``inputs`` (one dict a request, in submission order), each
        admission's prefill takes the next request's frontend inputs, as a
        user's request carries them (the reference's server has none: it
        encodes 8 zero frames into an empty cross cache, which decode then
        reads, and refuses a vision config), into caches of ``S_enc``
        cross frames."""

        def __init__(self, *args, inputs=None, S_enc=0, **kw):
            super().__init__(*args, **kw)
            if S_enc:
                self.caches = backbone.init_cache(
                    self.cfg, self.scfg.slots, self.scfg.cache_len,
                    S_enc=S_enc, device=self.device)
            self.inputs = inputs
            self.prefill_s = self.decode_s = 0.0
            self.prefills = self.prefill_tokens = self.decode_steps = 0
            self.finite = True

        def _prefill_with_inputs(self, tokens, caches_slot, true_len):
            batch = {"tokens": tokens[None, :], **self.inputs.pop(0)}
            logits, caches = backbone.prefill(self.cfg, self.params, batch,
                                              caches_slot)
            return logits[0], caches

        def _timed(self, fn, *args):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            logits, caches = fn(*args)
            self.finite &= bool(torch.isfinite(logits).all())
            return logits, caches, time.perf_counter() - t0

        def _prefill_impl(self, tokens, caches_slot, true_len):
            fn = (super()._prefill_impl if self.inputs is None
                  else self._prefill_with_inputs)
            logits, caches, dt = self._timed(fn, tokens, caches_slot,
                                             true_len)
            self.prefill_s += dt
            self.prefills += 1
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
    n_requests = spec.get("requests", SERVE_REQUESTS)
    cache_len = spec.get("cache_len", SERVE_CACHE)
    S_enc = spec.get("frames", 0)
    cfg = get_config(arch)
    cfg = dataclasses.replace(cfg, n_layers=spec.get("serve_layers",
                                                     cfg.n_layers),
                              **spec.get("cut", {}))
    torch.cuda.reset_peak_memory_stats()
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    t0 = time.perf_counter()
    params = backbone.init_params(cfg, gen, dtype=torch.bfloat16,
                                  device="cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    weight_bytes = sum(t.numel() * t.element_size() for t in _leaves(params))
    rng = np.random.default_rng(seed)
    lens = rng.integers(*spec.get("prompt_range", (1024, 2001)), n_requests)
    reqs = [Request(rid=i, prompt=rng.integers(1, cfg.vocab, size=int(n)),
                    max_new=max_new) for i, n in enumerate(lens)]
    # each request's frontend inputs (frames or patches), drawn on the card
    inputs = None
    if S_enc or spec.get("patches"):
        key, n_in = (("enc_embeds", S_enc) if S_enc
                     else ("vision_embeds", spec["patches"]))
        inputs = [{key: 0.02 * torch.randn((1, n_in, cfg.d_model),
                                           generator=gen, device="cuda")}
                  for _ in reqs]

    def server(requests, max_new=None):
        srv = TimedServer(cfg, params, ServeConfig(
            slots=SERVE_SLOTS, cache_len=cache_len, seed=seed),
            device="cuda", S_enc=S_enc,
            inputs=None if inputs is None else [inputs[r.rid]
                                                for r in requests])
        for r in requests:
            srv.submit(Request(rid=r.rid, prompt=r.prompt,
                               max_new=min(r.max_new, max_new or r.max_new)))
        return srv

    srv = server(reqs)
    reqs = srv.queue[:]
    timed_encode = encode_timer(torch, backbone)
    ops.reset_launches()
    t0 = time.perf_counter()
    steps = decode_tokens = 0
    with timed_encode:
        while srv.queue or any(r is not None for r in srv.slot_req):
            decode_tokens += srv.step()
            steps += 1
            if steps > 10_000:
                raise PhaseFailed("the serve loop did not drain")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k: ops.launches[k] for k in spec["kernels"]}
    # a kernel runs a fixed number of times a call: every prefill on the
    # instance spec["routes"] names for prefill, every decode step on the
    # one it names for decode
    routes = {k: dict(ops.routes[k]) for k in spec["kernels"]}
    per_call = {k: kernel_calls(cfg, k) for k in spec["kernels"]}
    calls = {"prefill": srv.prefills, "decode": srv.decode_steps}
    expected = {k: {name: calls[when] * per_call[k]
                    for when, name in spec["routes"][k].items()}
                for k in spec["kernels"]}
    routes_ok = routes == expected
    peak = torch.cuda.max_memory_allocated()
    last_pos = [len(r.prompt) + len(r.out) - 2 for r in reqs]
    # the ring must wrap where the arch has a window
    wrapped = sum(p >= cfg.window for p in last_pos) if cfg.window else None
    finished = all(r.done and len(r.out) == max_new for r in reqs)

    # The serve's last wave (its last SERVE_SLOTS requests: the served
    # prompts, at most REPLAY_NEW new tokens each) replayed on a fresh
    # server under the profiler, for the card's busy share and kernel time
    # by name; every other number here comes from the untraced run above.
    tsrv = server(reqs[-SERVE_SLOTS:], REPLAY_NEW)
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
        srv.caches, torch.full((SERVE_SLOTS,), cache_len // 2,
                               device="cuda")))
    ok = (finished and srv.finite and wrapped != 0 and routes_ok
          and all(v > 0 for v in launches.values()))
    extra = {}
    if cfg.is_encdec:
        extra = encdec_fields(cfg, params, srv.caches, timed_encode)
        extra["launch_serve"] = launch_serve_cli(arch)
        ok = ok and extra["launch_serve"]["ok"]
    if spec.get("patches"):
        extra = {"patches": spec["patches"]}
    emit({"phase": "serve", "ok": ok, "arch": arch,
          "layers": cfg.n_layers, "params": sum(
              t.numel() for t in _leaves(params)),
          "param_count": cfg.param_count(),
          **moe_read_fields(cfg, params),
          "dtype": "bfloat16", "cache_dtype": "bfloat16",
          "slots": SERVE_SLOTS, "cache_len": cache_len,
          "requests": n_requests, "max_new": max_new, "seed": seed,
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
          "routes": routes, "expected_routes": expected,
          "prefills": srv.prefills, "layers_per_call": per_call,
          "first_outputs": [r.out[:8] for r in reqs[:2]],
          **extra, "traced_window": trace})
    if not ok:
        raise PhaseFailed("a request did not finish, a logit was not "
                          "finite, no request wrapped the window, a "
                          f"kernel of {arch} was not launched, a "
                          "kernel ran a call on the wrong instance, or the "
                          "serving launcher failed")
    step = {"cfg": cfg, "cache_len": cache_len,
            "ms_per_decode_step": srv.decode_s / srv.decode_steps * 1e3,
            "peak_bytes": peak,
            "weight_read_bound_ms": (moe_read_fields(cfg, params).get(
                "step_read_bound_ms")
                or weight_bytes / HBM_BYTES_PER_S * 1e3)}
    del srv, params
    torch.cuda.empty_cache()
    return launches, lens, routes, step


def kernel_calls(cfg, kernel):
    """Launches of an attention or recurrence kernel in one prefill (the
    prefill kernels) or one decode step (the decode kernels): one a layer
    of its kinds, one more a cross-attention layer, and the encoder's
    layers for prefill attention."""
    from repro_torch.models.config import layer_plan

    plan = layer_plan(cfg)
    n = sum(b.kind in _KINDS[kernel] for b in plan)
    if kernel in ("flash_attention", "flash_decode"):
        n += sum(b.cross_attn for b in plan)
    if kernel == "flash_attention":
        n += cfg.encoder_layers
    return n


class encode_timer:
    """Within its block, ``backbone.encode`` (which ``backbone.prefill``
    calls through the module) runs synchronised and timed: its calls,
    frames and seconds."""

    def __init__(self, torch, backbone):
        self.torch, self.backbone = torch, backbone
        self.calls = self.frames = 0
        self.seconds = 0.0

    def __enter__(self):
        torch, self.encode = self.torch, self.backbone.encode

        def timed(cfg, params, enc_embeds, remat=False):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = self.encode(cfg, params, enc_embeds, remat=remat)
            torch.cuda.synchronize()
            self.seconds += time.perf_counter() - t0
            self.calls += 1
            self.frames += enc_embeds.shape[0] * enc_embeds.shape[1]
            return out
        self.backbone.encode = timed
        return self

    def __exit__(self, *exc):
        self.backbone.encode = self.encode


def encdec_fields(cfg, params, caches, timed):
    """An encoder-decoder serve's own figures: the encoder's frames a
    second against the least time its operations take on the bf16 tensor
    cores (the projections and MLP, 2 flops a weight a frame, and
    non-causal attention, 4 hd flops a (frame, frame) pair a head); the
    bytes a decode step must read, the decoder's weights (all but the
    encoder's) and every slot's cross K/V, over 3.35 TB/s."""
    D, F, H, Hkv, hd = (cfg.d_model, cfg.d_ff, cfg.n_heads, cfg.n_kv_heads,
                        cfg.head_dim)
    per_layer = 2 * (D * (H + 2 * Hkv) * hd + H * hd * D + 2 * D * F)
    S = timed.frames // max(timed.calls, 1)
    ops_ = cfg.encoder_layers * timed.frames * (per_layer + 4 * hd * H * S)
    enc_bytes = sum(t.numel() * t.element_size()
                    for t in _leaves(params["enc"]))
    dec_bytes = sum(t.numel() * t.element_size()
                    for t in _leaves(params)) - enc_bytes
    cross_bytes = sum(t.numel() * t.element_size() for c in caches
                      for t in c["cross"].values())
    return {"encoder_layers": cfg.encoder_layers, "frames": S,
            "encode_calls": timed.calls, "encode_s": timed.seconds,
            "encoder_frames_per_s": timed.frames / timed.seconds,
            "encoder_bound_ms_a_request": bound_ms(
                enc_bytes, ops_ // max(timed.calls, 1),
                BF16_TC_OPS_PER_S)[0],
            "encoder_ms_a_request": timed.seconds / timed.calls * 1e3,
            "decoder_weight_bytes": dec_bytes, "cross_kv_bytes": cross_bytes,
            "step_read_bytes": dec_bytes + cross_bytes,
            "step_read_bound_ms": (dec_bytes + cross_bytes)
            / HBM_BYTES_PER_S * 1e3}


def launch_serve_cli(arch):
    """``python -m repro_torch.launch.serve --arch <arch> --requests 4
    --slots 4 --max-new 16`` as a process on the card (the launcher's
    server, as the reference's: 8 zero frames into an empty cross cache
    for an encoder-decoder); it must exit 0 having served every
    request."""
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch", arch,
         "--requests", "4", "--slots", "4", "--max-new", "16"],
        capture_output=True, text=True, timeout=600, env=_cli_env(),
        cwd=str(ROOT))
    out = proc.stdout.strip().splitlines()
    return {"returncode": proc.returncode,
            "wall_s": time.perf_counter() - t0,
            "summary": out[0] if out else None,
            "stderr_tail": proc.stderr[-600:] if proc.returncode else "",
            "ok": proc.returncode == 0
            and bool(out) and out[0].startswith("[serve] 4/4 requests")}


def moe_read_fields(cfg, params):
    """For an MoE config, the weight bytes a decode step reads and its
    bound: the sort-based dispatch multiplies the buffers of all E experts
    every step, so a step reads every expert (all the weights); beside it,
    the bytes of the parameters one token activates (its top-k experts of
    each MoE layer, the rest in full).  Empty for a dense config."""
    from repro_torch.models.config import MOE, layer_plan
    from repro_torch.models.moe import capacity

    if not cfg.n_experts:
        return {}
    plan = layer_plan(cfg)
    moe_bytes = sum(t.numel() * t.element_size()
                    for spec, layer in zip(plan, params["layers"])
                    if spec.mlp == MOE
                    for k, t in layer["mlp"].items()
                    if k in ("wg", "wu", "wd"))
    total = sum(t.numel() * t.element_size() for t in _leaves(params))
    experts = cfg.n_experts + cfg.n_experts_pad
    active = total - moe_bytes * (experts - cfg.top_k) // experts
    return {"moe_layers": sum(b.mlp == MOE for b in plan),
            "expert_bytes": moe_bytes, "step_read_bytes": total,
            "step_read_bound_ms": total / HBM_BYTES_PER_S * 1e3,
            "active_weight_bytes": active,
            "active_read_bound_ms": active / HBM_BYTES_PER_S * 1e3,
            "decode_capacity": capacity(cfg, SERVE_SLOTS)}


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


def attention_fields(torch, np, arch, launches, prompt_lens, functions,
                     hgmma, gen):
    """flash attention and flash decode at the shapes ``arch``'s serve gave
    them (bf16, as served), inputs drawn from ``gen``: one prefill of the
    median served prompt under the arch's window, if any, and one decode
    step of the four slots at mid-run positions (the first four prompts
    plus half the new tokens) over a layer's cache (the window, or the
    serve's cache length).  Each against its plain version and SDPA (the
    backend it took named), timed with both, beside its bound.  An MLA
    arch calls prefill attention with per-head keys of qk_nope + qk_rope
    and values of v_head_dim, scaled by 1/sqrt(qk head dim), and decodes
    with no kernel.  An encoder-decoder's entries carry its other shapes
    beside them: prefill attention over the encoder's frames
    (``"encoder"``, bidirectional) and the median prompt's cross-attention
    to them (``"cross"``), and a decode step's cross-attention over every
    frame (``"cross"``).  Returns the fields of the two entries (the
    decode's None for MLA)."""
    from repro_torch.configs import get_config

    spec = SERVE_ARCHS[arch]
    cfg = get_config(arch)
    H, Hkv, hd, hdv, win = (cfg.n_heads, cfg.n_kv_heads, cfg.head_dim,
                            cfg.head_dim, cfg.window)
    scale = None
    if cfg.mla:
        Hkv, hd, hdv = H, cfg.qk_nope_head_dim + cfg.qk_rope_head_dim, \
            cfg.v_head_dim
        scale = 1.0 / hd ** 0.5
    L = int(np.median(prompt_lens))
    heads = (H, Hkv, hd, hdv)
    prefill = _prefill_fields(torch, gen, L, L, heads, True, win, scale,
                              launches["flash_attention"], functions, hgmma)
    if cfg.mla:
        return prefill, None
    cache_len = spec.get("cache_len", SERVE_CACHE)
    S = min(cache_len, win) if win else cache_len
    lens = [int(n) + spec["max_new"] // 2 for n in prompt_lens[:SERVE_SLOTS]]
    decode = _decode_fields(torch, gen, S, heads, lens,
                            launches["flash_decode"], functions)
    F = spec.get("frames", 0)
    if F:
        prefill["encoder"] = _prefill_fields(
            torch, gen, F, F, heads, False, 0, None, None, functions, hgmma)
        prefill["cross"] = _prefill_fields(
            torch, gen, L, F, heads, False, 0, None, None, functions, hgmma)
        decode["cross"] = _decode_fields(torch, gen, F, heads,
                                         [F] * SERVE_SLOTS, None, functions)
    return prefill, decode


def _prefill_fields(torch, gen, Lq, Lk, heads, causal, win, scale, launches,
                    functions, hgmma):
    """One bf16 prefill attention call (1, Lq queries, Lk keys) against its
    plain version and SDPA, timed, beside its bound."""
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import (
        attention_route, flash_attention_cuda, flash_attention_plain)
    H, Hkv, hd, hdv = heads
    bf = torch.bfloat16
    kw = dict(causal=causal, window=win, scale=scale)
    q = _randn(torch, gen, (1, Lq, H, hd), bf)
    k = _randn(torch, gen, (1, Lk, Hkv, hd), bf)
    v = _randn(torch, gen, (1, Lk, Hkv, hdv), bf)
    got = flash_attention_cuda(q, k, v, **kw)
    want = flash_attention_plain(q, k, v, **kw)
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    if win:
        pos = torch.arange(Lq, device="cuda")
        sdpa_kw = dict(attn_mask=((pos[None, :] <= pos[:, None])
                                  & (pos[None, :] > pos[:, None] - win)),
                       enable_gqa=H != Hkv)
    else:
        sdpa_kw = dict(is_causal=causal, enable_gqa=H != Hkv, scale=scale)

    def sdpa():
        return F.scaled_dot_product_attention(qt, kt, vt, **sdpa_kw)
    backend = sdpa_backend(torch, qt, kt, vt, **sdpa_kw)
    lib_out = sdpa().transpose(1, 2)
    pairs = attention_pairs(Lq, Lk, causal, win)
    n_bytes = 2 * (Lq * H * (hd + hdv) + Lk * Hkv * (hd + hdv))
    n_ops = 2 * (hd + hdv) * H * pairs
    fa_bound, fa_by = bound_ms(n_bytes, n_ops, BF16_TC_OPS_PER_S)
    out = {
        "instance": attention_instances(functions, attention_route(q, k, v),
                                        q, v, H // Hkv, decode=False,
                                        hgmma=hgmma),
        "shape": [1, Lq, H, Hkv, hd] + ([hdv] if hdv != hd else [])
        + ([Lk] if Lk != Lq else []),
        "causal": causal, "dtype": "bfloat16", "window": win, "scale": scale,
        "max_abs_err": _err(got, want),
        "library_max_abs_diff": _err(got, lib_out),
        "ms": device_ms(torch, lambda: flash_attention_cuda(q, k, v, **kw),
                        20),
        "eager_ms": eager_ms(torch, lambda: flash_attention_cuda(
            q, k, v, **kw), 20),
        "plain_ms": device_ms(torch, lambda: flash_attention_plain(
            q, k, v, **kw), 2),
        "device_us_by_kernel": device_us_by_kernel(
            torch, lambda: flash_attention_cuda(q, k, v, **kw), 20),
        "library": "F.scaled_dot_product_attention", **backend,
        "library_ms": device_ms(torch, sdpa, 20),
        "bound_ms": fa_bound, "bound_by": fa_by,
        "bound_rate": "bf16 tensor cores 989 TFLOP/s; HBM 3.35 TB/s",
        "bound_ms_fp32_cuda_cores": bound_ms(n_bytes, n_ops,
                                             FP32_OPS_PER_S)[0],
    }
    return out if launches is None else {"launches": launches, **out}


def _decode_fields(torch, gen, S, heads, lens_list, launches, functions):
    """One bf16 decode step of len(lens_list) slots over a cache of S slots
    against its plain version and SDPA (the valid slots as a mask),
    timed, beside its bound."""
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import (
        decode_route, flash_decode_cuda, flash_decode_plain)
    H, Hkv, hd, _ = heads
    bf = torch.bfloat16
    B = len(lens_list)
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
    sdpa_kw = dict(attn_mask=dmask, enable_gqa=H != Hkv)

    def sdpa_decode():
        return F.scaled_dot_product_attention(qd, kd, vd, **sdpa_kw)
    lib_out = sdpa_decode()[:, :, 0]
    # the bytes of the slots read (each request's valid keys and values)
    n_bytes = 2 * (2 * B * H * hd + sum(valid) * Hkv * 2 * hd)
    n_ops = 4 * hd * H * sum(valid)
    fd_bound, fd_by = bound_ms(n_bytes, n_ops, BF16_TC_OPS_PER_S)
    out = {
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
        **sdpa_backend(torch, qd, kd, vd, **sdpa_kw),
        "library_ms": device_ms(torch, sdpa_decode, 200),
        "bound_ms": fd_bound, "bound_by": fd_by,
        "bound_rate": "HBM 3.35 TB/s; bf16 tensor cores 989 TFLOP/s",
    }
    return out if launches is None else {"launches": launches, **out}


# the kernels line's sub-entries: each served arch's shapes beside
# RecurrentGemma-2B's
_SUB_ENTRY = {LLAMA: "llama3_8b", QWEN_MOE: "qwen2_moe_a2_7b",
              DEEPSEEK: "deepseek_v3_671b", WHISPER: "whisper_large_v3",
              INTERNVL: "internvl2_76b"}


def serve_kernel_entries(torch, np, served, functions, hgmma,
                         rglru_functions):
    """The kernels line's entries of the attention kernels and the RG-LRU
    scan, each at the shape its path used (:func:`attention_fields`):
    RecurrentGemma-2B's serve, with the other served archs' beside it
    under their names (``"llama3_8b"``, ``"qwen2_moe_a2_7b"``,
    ``"deepseek_v3_671b"``: its MLA prefill only, its decode has no
    kernel), and the RG-LRU scan per route (:func:`recurrence_entries`).
    ``served``: each served arch's (launches, prompt lengths, routes, its
    step's measurements)."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import rglru_scan as rglru

    launches, prompt_lens, routes, _ = served[RG]
    W = get_config(RG).lru_width
    gen = torch.Generator(device="cuda")
    gen.manual_seed(11)
    fixed = {"route": "cuda",
             "source": "src/repro_torch/kernels/csrc/attention.cu",
             "wrapper": "src/repro_torch/kernels/flash_attention.py"}
    prefill, decode = attention_fields(torch, np, RG, launches, prompt_lens,
                                       functions, hgmma, gen)
    entries = [
        {"name": "flash_attention", **fixed,
         "replaces": "src/repro/kernels/flash_attention.py:78", **prefill},
        {"name": "flash_decode", **fixed,
         "replaces": "src/repro/kernels/flash_attention.py:162", **decode}]
    L = int(np.median(prompt_lens))
    for arch, seed in ((LLAMA, 14), (QWEN_MOE, 15), (DEEPSEEK, 16),
                       (WHISPER, 17), (INTERNVL, 18)):
        agen = torch.Generator(device="cuda")
        agen.manual_seed(seed)
        a_launches, a_lens, a_routes, _ = served[arch]
        for entry, fields in zip(entries, attention_fields(
                torch, np, arch, a_launches, a_lens, functions, hgmma,
                agen)):
            if fields is not None:
                entry[_SUB_ENTRY[arch]] = dict(
                    fields, routes=a_routes[entry["name"]])

    # ---- RG-LRU scan: the decode step and the median prompt --------------
    def scan_inputs(B, T):
        a = torch.sigmoid(_randn(torch, gen, (B, T, W), torch.float32)) * 0.9
        return (a, _randn(torch, gen, (B, T, W), torch.float32),
                _randn(torch, gen, (B, W), torch.float32))

    def scan_bound(args):
        B, T, _ = args[0].shape
        return bound_ms(4 * (3 * B * T * W + 2 * B * W), 2 * B * T * W,
                        FP32_OPS_PER_S)

    entries += recurrence_entries(
        torch, "rglru_scan", rglru.rglru_scan_cuda,
        rglru.linear_recurrence_plain, rglru.linear_recurrence_chunked_plain,
        {"sequential": scan_inputs(SERVE_SLOTS, 1),
         "chunked": scan_inputs(1, L)},
        routes["rglru_scan"], scan_bound, rglru_functions,
        {"sequential": ["rglru_scan_kernel"],
         "chunked": ["rglru_chunk_summary_kernel", "rglru_chunk_out_kernel"]},
        {"source": "src/repro_torch/kernels/csrc/rglru.cu",
         "wrapper": "src/repro_torch/kernels/rglru_scan.py",
         "replaces": "src/repro/kernels/rglru_scan.py:63",
         "dtype": "float32"})
    # the sequential route serves callers of the reference's function; the
    # serve's decode takes the gated one
    seq = next(e for e in entries if e["name"] == "rglru_scan"
               and e["instance"] == "sequential")
    a, b, h0 = scan_inputs(SERVE_SLOTS, 1)
    seq.update(on_main_path=False, library="torch.addcmul",
               library_note="b + a * h0 at T = 1 in one call (may round "
                            "as an FMA)",
               library_ms=device_ms(
                   torch, lambda: torch.addcmul(b[:, 0], a[:, 0], h0), 200))
    entries.append(gated_entry(
        torch, gated_inputs(torch, gen, SERVE_SLOTS, 1, W, torch.bfloat16),
        routes["rglru_scan"].get("gated", 0), rglru_functions))
    tol = {"flash_attention": TOL["bfloat16"], "flash_decode": TOL["bfloat16"],
           "rglru_scan": RGLRU_ATOL}
    subs = [e[k] for e in entries for k in _SUB_ENTRY.values() if k in e]
    ok = all((f["launches"] > 0 or not f.get("on_main_path", True))
             and f["max_abs_err"] <= tol[e["name"]]
             for e in entries
             for f in [e] + [e[k] for k in _SUB_ENTRY.values() if k in e])
    ok = ok and all(f[k]["max_abs_err"] <= TOL["bfloat16"]
                    for f in subs for k in ("encoder", "cross") if k in f)
    return entries, ok


def gated_entry(torch, args, launches, functions):
    """The kernels line's entry of the RG-LRU's gated route at the served
    decode step (4 slots, T = 1, bf16 inputs): its launches in the serve
    (one a recurrent layer a decode step), the largest difference from the
    gate chain run operator by operator, device ms of both, eager ms, the
    bound, the ptxas registers and spills."""
    from repro_torch.kernels import rglru_scan as rglru

    got = rglru.rglru_gated_cuda(*args)
    want = rglru.rglru_gated_plain(*args)
    torch.cuda.synchronize()
    B, T, W = args[0].shape
    n, el = B * T * W, args[0].element_size()
    # bytes: xc and the two products, the biases and lam read once, h0
    # read, h and hT written; operations: 20 an element (2 bias adds, 2
    # sigmoids of 3, log_a, a, ig * xc, 2 log_a, exp, 1 -, clamp, sqrt,
    # beta * x, the step's multiply and add) and 6 a channel (softplus, -C)
    b_ms, b_by = bound_ms(3 * n * el + 3 * W * el + 4 * B * W + 4 * n
                          + 4 * B * W, 20 * n + 6 * W, FP32_OPS_PER_S)
    return {
        "name": "rglru_scan", "route": "cuda", "instance": "gated",
        "source": "src/repro_torch/kernels/csrc/rglru.cu",
        "wrapper": "src/repro_torch/kernels/rglru_scan.py",
        "replaces": "src/repro/kernels/rglru_scan.py:63",
        "fuses": "src/repro/models/blocks.py:478, 490-496 (XLA elementwise)",
        "dtype": "bfloat16", "launches": launches, "shape": [B, T, W],
        "max_abs_err": max(_err(g, w) for g, w in zip(got, want)),
        "bit_equal": all(torch.equal(g, w) for g, w in zip(got, want)),
        "ptxas": [ptxas_of(functions, "rglru_gated_kernelI13__nv_bfloat16E")],
        "ms": device_ms(torch, lambda: rglru.rglru_gated_cuda(*args), 200),
        "eager_ms": eager_ms(torch, lambda: rglru.rglru_gated_cuda(*args),
                             200),
        "plain_ms": device_ms(torch, lambda: rglru.rglru_gated_plain(*args),
                              200),
        "plain_eager_ms": eager_ms(
            torch, lambda: rglru.rglru_gated_plain(*args), 200),
        "library": None, "library_ms": None,
        "bound_ms": b_ms, "bound_by": b_by,
        "bound_rate": "HBM 3.35 TB/s; FP32 67 TFLOP/s"}


def recurrence_entries(torch, name, kernel, plain, chunked_plain, inputs,
                       launches, bound, functions, fragments, fixed):
    """The kernels line's entries of a recurrence, one a route: the route's
    launches in the serve, the largest difference from the plain version
    (and whether the chunked route equals its own plain algorithm bit for
    bit), device ms of the route and of its plain version, eager ms, the
    bound, the ptxas registers and spills of the route's kernel functions
    (``fragments`` of their names); on the chunked route, its device time
    by kernel name and the sequential route's time at the same shape, in
    the same call."""
    out = []
    for route, args in inputs.items():
        got = kernel(*args, route=route)
        want = plain(*args)
        mine = chunked_plain(*args)
        torch.cuda.synchronize()
        iters = 200 if args[0].shape[1] == 1 else 20
        b_ms, b_by = bound(args)
        entry = dict(fixed, name=name, route="cuda", instance=route,
                     launches=launches.get(route, 0),
                     # (B, T, W), or the WKV's (B, T, H, dk, dv)
                     shape=list(args[0].shape) + list(
                         args[2].shape[-1:] if args[0].dim() == 4 else ()),
                     max_abs_err=max(_err(g, w) for g, w in zip(got, want)),
                     ptxas=[ptxas_of(functions, f) for f in fragments[route]],
                     ms=device_ms(torch, lambda: kernel(*args, route=route),
                                  iters),
                     eager_ms=eager_ms(torch, lambda: kernel(
                         *args, route=route), iters),
                     plain_ms=device_ms(torch, lambda: plain(*args),
                                        iters if iters > 20 else 1),
                     library=None, library_ms=None,
                     bound_ms=b_ms, bound_by=b_by)
        if route == "chunked":
            entry["chunked_plain_max_abs_err"] = max(
                _err(g, w) for g, w in zip(got, mine))
            entry["device_us_by_kernel"] = device_us_by_kernel(
                torch, lambda: kernel(*args, route=route), iters)
            entry["sequential_ms"] = device_ms(
                torch, lambda: kernel(*args, route="sequential"), iters)
            entry["faster_than_sequential"] = (entry["ms"]
                                               < entry["sequential_ms"])
        out.append(entry)
    return out


def wkv6_entries(torch, np, launches, prompt_lens, routes, functions):
    """The kernels line's entries of the WKV recurrence, one a route: the
    RWKV6-7B decode step (4 slots, T = 1, bf16 r/k/v) on the sequential
    route and the prefill of the median served prompt on the chunked one
    (:func:`recurrence_entries`)."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import rwkv6_scan as rwkv

    cfg = get_config(RWKV)
    H, dk = cfg.n_heads, cfg.rwkv_head_dim
    gen = torch.Generator(device="cuda")
    gen.manual_seed(13)
    L = int(np.median(prompt_lens))
    bf = "13__nv_bfloat16"
    entries = recurrence_entries(
        torch, "wkv6", rwkv.wkv6_cuda, rwkv.wkv6_plain,
        rwkv.wkv6_chunked_plain,
        {"sequential": wkv6_inputs(torch, gen, SERVE_SLOTS, 1, H, dk, dk,
                                   torch.bfloat16, 0.9),
         "chunked": wkv6_inputs(torch, gen, 1, L, H, dk, dk, torch.bfloat16,
                                0.9)},
        routes["wkv6"], lambda args: wkv6_bound(args[0], args[2]), functions,
        # the 32-column tile with 16 rows a lane at dk = 64 (csrc/wkv6.cu
        # picks it for 4 slots of 64 heads); the chunked route's three
        {"sequential": [f"wkv6_kernelI{bf}Li16ELi32E"],
         "chunked": [f"wkv6_chunk_state_kernelI{bf}E",
                     "wkv6_chunk_prefix_kernel",
                     f"wkv6_chunk_out_kernelI{bf}E"]},
        {"source": "src/repro_torch/kernels/csrc/wkv6.cu",
         "wrapper": "src/repro_torch/kernels/rwkv6_scan.py",
         "replaces": "src/repro/kernels/rwkv6_scan.py:77",
         "dtype": "bfloat16",
         "bound_rate": "HBM 3.35 TB/s; FP32 67 TFLOP/s, 5 flops a (row, "
                       "column) pair, 3 a row and 2 a column, a step"})
    ok = all(e["launches"] > 0 and e["max_abs_err"] <= WKV_TOL
             for e in entries)
    return entries, ok


def phase_kernel_line(torch, np, launches, stats, functions,
                      session_launches, scenario_launches, serve_launches,
                      usage_paper):
    from repro_torch.kernels.alloc_matvec import (alloc_matvec_cuda,
                                                  alloc_matvec_plain)
    from repro_torch.kernels.maxmin_solve import (maxmin_solve_cuda,
                                                  maxmin_solve_plain,
                                                  solve_route)

    dev = torch.device("cuda")
    rng = np.random.default_rng(11)
    mv_shape = stats["avg_shapes"].most_common(1)[0][0]
    sv_shape = stats["min_shapes"].most_common(1)[0][0]

    # the matvec at the OPT=AVG floor's most used shape (its only launches
    # on the main path)
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
        "launches_session": {k: v["alloc_matvec"]
                             for k, v in session_launches.items()},
        "launches_scenarios": {k: v["alloc_matvec"]
                               for k, v in scenario_launches.items()},
        "launches_serve": serve_launches["alloc_matvec"],
        "ptxas": ptxas_of(functions, "alloc_matvec_kernel"),
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

    # the solve at OPT=MIN's most used shape, on engine-like incidences
    # (needs 0.25-1 times multiplicities 1-3 on a tenth of the entries,
    # every column running), which take 9-13 rounds a lane
    B, N, W = sv_shape
    need = rng.choice([0.25, 0.5, 1.0], (B, 1, W))
    mult = rng.integers(1, 4, (B, N, W)) * (rng.random((B, N, W)) < 0.1)
    weight = need * mult
    args = [torch.from_numpy(a).to(dev) for a in (
        weight > 0, weight, np.ones((B, W), dtype=bool))]
    ky, kr = maxmin_solve_cuda(*args)
    py, pr = maxmin_solve_plain(*args)
    err = float((ky - py).abs().max()) if ky.numel() else 0.0
    if not torch.equal(kr, pr):
        err = float("inf")
    rounds = kr.cpu().numpy()
    # bytes: the weights, the presence mask and the active mask read once,
    # y written once, a round count a lane; operations: per round of a lane
    # two chains (a multiply and an add) a (node, column), and 11 a node
    # (level, drop test, tie test)
    sv_bound, sv_by = bound_ms(
        9 * B * N * W + 9 * B * W + 4 * B,
        int(rounds.sum()) * (4 * N * W + 11 * N))
    route = solve_route(*args)
    solve = {
        "name": "maxmin_solve", "route": "cuda", "instance": route,
        "source": "src/repro_torch/kernels/csrc/alloc.cu",
        "wrapper": "src/repro_torch/kernels/maxmin_solve.py",
        "replaces": "src/repro/core/alloc_jax.py:206-276",
        "launches": launches["maxmin_solve"], "shape": [B, N, W],
        "launches_session": {k: v["maxmin_solve"]
                             for k, v in session_launches.items()},
        "launches_scenarios": {k: v["maxmin_solve"]
                               for k, v in scenario_launches.items()},
        "launches_serve": serve_launches["maxmin_solve"],
        "ptxas": ptxas_of(functions, "maxmin_solve_kernelILb"
                          + ("1" if route == "shared" else "0")),
        "rounds_mean": float(rounds.mean()), "rounds_max": int(rounds.max()),
        "max_abs_err": err,
        "ms": device_ms(torch, lambda: maxmin_solve_cuda(*args), 200),
        "eager_ms": eager_ms(torch, lambda: maxmin_solve_cuda(*args), 200),
        # the plain loop reads the host each round, so no CUDA graph
        "plain_ms": eager_ms(torch, lambda: maxmin_solve_plain(*args), 3),
        "plain_ms_how": "eager (host reads a round)",
        "library": None, "library_ms": None,
        "bound_ms": sv_bound, "bound_by": sv_by,
        "bound_rate": "HBM 3.35 TB/s; FP64 34 TFLOP/s",
    }
    usage = node_usage_entry(torch, functions, serve_launches["node_usage"],
                             usage_paper)
    kernels = [matvec, solve, usage]
    # node_usage is on no path (the stretch passes scatter on the host), so
    # only the path's kernels must have launched
    ok = all((e["launches"] > 0 or not e["on_main_path"])
             and e["max_abs_err"] == 0.0 for e in kernels)
    return kernels, ok


def node_usage_entry(torch, functions, launches, paper):
    """The node-usage kernel on phase 2's lists at the stretch passes'
    paper shape (16 lanes, 128 nodes, 128 x 32 entries a lane), timed
    against its plain version and ``index_add_`` (atomics: not bit-equal
    in general, and not used by the port)."""
    from repro_torch.kernels.node_usage import (node_usage_cuda,
                                                node_usage_plain)

    nodes, vals, N = paper["nodes"], paper["vals"], paper["n_nodes"]
    k, p = paper["kernel"], paper["plain"]
    dev = nodes.device
    B, K = vals.shape
    # index_add_ over the in-range entries, each lane's block of N outputs
    keep = (nodes >= 0) & (nodes < N)
    flat = (nodes + torch.arange(B, device=dev)[:, None] * N)[keep]
    flat_vals = vals[keep]

    def library():
        out = torch.zeros(B * N, dtype=torch.float64, device=dev)
        return out.index_add_(0, flat, flat_vals)

    lib = library().view(B, N)
    bound, by = bound_ms(B * K * (8 + 8) + B * N * 8, paper["adds"])
    return {
        "name": "node_usage", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/alloc.cu",
        "wrapper": "src/repro_torch/kernels/node_usage.py",
        "replaces": "src/repro/core/alloc_jax.py:317-348",
        # counted on phase 4e's run, as every launch count of the line
        "launches": launches, "on_main_path": False,
        "launches_note": "no path calls it: the stretch passes scatter "
                         "with np.add.at on the host",
        "shape": [B, N, K],
        "ptxas": ptxas_of(functions, "node_usage_kernel"),
        "max_abs_err": float((k - p).abs().max()),
        "equal_plain": bool(torch.equal(k, p)),
        "ms": device_ms(torch, lambda: node_usage_cuda(nodes, vals, N), 200),
        "eager_ms": eager_ms(torch, lambda: node_usage_cuda(nodes, vals, N),
                             200),
        # K small launches a call: eager, a few calls
        "plain_ms": eager_ms(torch, lambda: node_usage_plain(nodes, vals, N),
                             3),
        "plain_ms_how": "eager (one small launch a list column)",
        "library": "torch.Tensor.index_add_",
        "library_ms": device_ms(torch, library, 200),
        "library_bit_equal": bool(torch.equal(lib, k)),
        "library_note": "atomic adds in a run-dependent order: not "
                        "bit-equal to the in-order sum in general",
        "bound_ms": bound, "bound_by": by,
        "bound_rate": "HBM 3.35 TB/s",
    }


# --------------------------------------------------------------------------- #
# phase 9: train                                                               #
# --------------------------------------------------------------------------- #
# a learning rate of 0 at step 1 where a check takes more than one step
# (then the moments carry step 1's gradients into the comparison), 1e-3
# from the first step where it takes one
TRAIN_LR, TRAIN_TOTAL = 1e-3, 100
TRAIN_METRIC_RTOL = 1e-4        # every step's loss, grad norm, aux and mtp
TRAIN_TOL = MODEL_TOL           # every leaf of the final state, atol = rtol
# a leaf class held to a budget instead: up to max(2, 0.5 %) of its
# elements outside TRAIN_TOL, all within 0.05 (tests/train_compare.py)
TRAIN_LOOSE_FRAC, TRAIN_LOOSE_ABS = 0.005, 0.05
# (a): (arch, layers, batch, tokens, steps, microbatches, Adafactor, int8
# compression, weight seed), full width, cut in depth alone
# (train_config).  A check's host side is bound by work in proportion to
# the parameters (the optimizer over the vocabularies' embedding and head,
# the gradients' sums), which a shorter T does not cut, so the large ones
# take one step.  After RecurrentGemma-2B and RWKV6-7B come the families
# the CPU tests alone trained before: Qwen1.5-MoE's two MoE layers (the
# routed path, whose softmax router DeepSeek-V3 shares: its 256-expert
# layer, 11.3 B parameters, about 181 GB with AdamW's moments, does not
# fit the card), DeepSeek-V3's first layer (MLA over a dense MLP) and its
# MTP depth, Whisper-large-v3's 2 + 2 layers over 1,500 frames (the
# least host memory: first, while phase 10 (a)'s pool runs),
# InternVL2-76B's first layer with its 256 patches.  Qwen1.5-MoE takes
# one microbatch of one step, Whisper one row (PERF.md section 4): more
# ran out of the card's memory or the script's time.  They
# run as a part (train_families), while the scheduling phases leave the
# card's memory free: an optimizer step holds the old state, the
# gradients and the new one at once (DeepSeek-V3: 69 GB of the card, 64
# GB of the host).  Weight seeds: their model checks'.
TRAIN_CHECKS = (
    ("smollm-360m", 2, 2, 512, 3, 1, False, False, 2406),
    ("smollm-360m", 2, 2, 512, 3, 2, True, False, 2406),
    ("smollm-360m", 2, 2, 512, 3, 1, False, True, 2406),
    (RG, 3, 1, 256, 1, 1, False, False, 2402),
    (RWKV, 1, 1, 256, 1, 1, False, False, 2404),
    (WHISPER, 2, 1, 448, 2, 1, False, True, 2416),
    (QWEN_MOE, 2, 2, 256, 1, 1, False, False, 2413),
    (DEEPSEEK, 1, 1, 256, 1, 1, True, False, 2414),
    (INTERNVL, 1, 1, 512, 1, 1, True, False, 2417),
)
# the kernels each arch's training launches, and the route of each (fp32:
# attention on the tensor cores in 3xTF32, whose instance follows the
# shape: route_counts)
_TRAIN_ATTN = {"flash_attention": "tf32x3"}
TRAIN_KERNELS = {"smollm-360m": _TRAIN_ATTN,
                 RG: {"flash_attention": "tf32x3",
                      "rglru_scan": "chunked"},
                 RWKV: {"wkv6": "chunked"},
                 QWEN_MOE: _TRAIN_ATTN, DEEPSEEK: _TRAIN_ATTN,
                 WHISPER: _TRAIN_ATTN, INTERNVL: _TRAIN_ATTN}
# the archs whose checks of (a) run as a part of their own beside phases
# 4-4e and 10 (a) (train_families), and whose attention shapes the
# kernels line times
TRAIN_PART_ARCHS = (QWEN_MOE, DEEPSEEK, WHISPER, INTERNVL)
# that part's niceness: it takes the cores the other parts leave idle,
# with half the cores' threads, which sleep when idle (PART_ENV)
TRAIN_PART_NICE = 19
# (b): the launcher at full size
TRAIN_ARCH, TRAIN_STEPS, TRAIN_BATCH, TRAIN_SEQ = "smollm-360m", 12, 4, 1024
TRAIN_CKPT_EVERY, TRAIN_FAILURES = 4, (6, 9)
TRAIN_LOSS_RTOL = 1e-5          # the reference's restart bound


def train_config(case):
    """The config a check of (a) trains: its arch's published one with
    ``n_layers`` cut to the case's layers (and an encoder-decoder's
    ``encoder_layers`` too), nothing else changed."""
    from repro_torch.configs import get_config

    arch, layers = case[:2]
    cfg = get_config(arch)
    cut = {"n_layers": layers}
    if cfg.is_encdec:
        cut["encoder_layers"] = layers
    return dataclasses.replace(cfg, **cut)


def route_counts(instances):
    """Launches by route from launches by instance (``ops.routes``): an
    instance's name up to its template arguments."""
    out = Counter()
    for name, n in instances.items():
        out[name.split("<")[0]] += n
    return dict(out)


def train_launches(cfg, kernel):
    """Launches of ``kernel`` in one microbatch of a train step under
    remat: two for each of a prefill's calls (:func:`kernel_calls`: the
    decoder layers of its kinds, their cross-attention, the encoder's
    layers), the forward and the recompute; and attention's one more for
    an MTP depth, whose block ``_mtp_loss`` runs without remat."""
    return 2 * kernel_calls(cfg, kernel) + int(
        kernel == "flash_attention" and cfg.mtp)


def train_routing_where(n_moe, microbatches):
    """(step, layer) of each MoE call a train step records: in each
    microbatch the forward's layers in order, then the remat recompute's
    in reverse (the backward's order)."""
    layer = list(range(n_moe)) + list(reversed(range(n_moe)))
    per_step = 2 * n_moe * microbatches
    return lambda i: (i // per_step, layer[i % (2 * n_moe)])


class attention_shapes:
    """Within its block, the card's flash attention launches counted by
    their arguments, ``(B, Tq, Tk, H, Hkv, hd, hdv, causal, scale)``, by
    wrapping ``ops.flash_attention_cuda``, which ``ops`` calls where it
    launches the kernel."""

    def __init__(self):
        from repro_torch.kernels import ops
        self.ops, self.counts = ops, Counter()

    def __enter__(self):
        self.kernel = kernel = self.ops.flash_attention_cuda
        counts = self.counts

        def counted(q, k, v, *, causal=True, window=0, q_offset=0,
                    scale=None):
            B, Tq, H, hd = q.shape
            counts[(B, Tq, k.shape[1], H, k.shape[2], hd, v.shape[-1],
                    bool(causal), scale)] += 1
            return kernel(q, k, v, causal=causal, window=window,
                          q_offset=q_offset, scale=scale)
        self.ops.flash_attention_cuda = counted
        return counts

    def __exit__(self, *exc):
        self.ops.flash_attention_cuda = self.kernel


class peak_memory:
    """Within its block, a thread reads every 0.1 s this process's
    resident memory (``VmRSS``) and the card's memory in use by every
    process (``cudaMemGetInfo``): the peaks, in bytes, as ``host`` and
    ``card``."""

    def __init__(self, torch):
        import threading
        self.torch, self.host, self.card = torch, 0, 0
        self.stop = threading.Event()
        self.thread = threading.Thread(target=self._run, daemon=True)

    def _sample(self):
        with open("/proc/self/status") as f:
            rss = next(int(line.split()[1]) * 1024 for line in f
                       if line.startswith("VmRSS:"))
        free, total = self.torch.cuda.mem_get_info()
        self.host = max(self.host, rss)
        self.card = max(self.card, total - free)

    def _run(self):
        while not self.stop.wait(0.1):
            self._sample()

    def __enter__(self):
        self._sample()
        self.thread.start()
        return self

    def __exit__(self, *exc):
        self.stop.set()
        self.thread.join()
        self._sample()


def _host_mem_total():
    with open("/proc/meminfo") as f:
        return next(int(line.split()[1]) * 1024 for line in f
                    if line.startswith("MemTotal:"))


def _leaf_diff(torch, card, host, bf16):
    """(elements outside TRAIN_TOL — one bf16 rounding step more for a
    bf16 leaf —, the largest absolute difference) of one leaf, worked on
    the card."""
    c = card.detach().float()
    h = host.detach().to(c.device).float()
    d = (c - h).abs()
    rtol = TRAIN_TOL + (2.0 ** -7 if bf16 else 0.0)
    return int((d > TRAIN_TOL + rtol * h.abs()).sum()), float(d.max())


def _named_leaves(tree, path=""):
    """(path, leaf) of a train state's tree in ``train.tree.flatten``'s
    order: dict keys sorted, list and tuple items by index, ``None``
    empty."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _named_leaves(tree[k], f"{path}/{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _named_leaves(v, f"{path}/{i}")
    elif tree is not None:
        yield path, tree


def _compare_states(torch, card, host, loose):
    """Every leaf of the card's final train state against the host's, by
    class (params, mu, nu, err): leaves, elements, elements outside
    TRAIN_TOL, the largest difference and the leaves with any element
    outside; ``loose`` names the classes held to the budget, the others
    must have none outside."""
    classes = {"params": card.params, "mu": card.opt.mu, "nu": card.opt.nu,
               "err": card.err}
    hosts = {"params": host.params, "mu": host.opt.mu, "nu": host.opt.nu,
             "err": host.err}
    out, ok = {}, bool(int(card.opt.step) == int(host.opt.step))
    for name, tree in classes.items():
        cl = list(_named_leaves(tree))
        hl = [h for _, h in _named_leaves(hosts[name])]
        if not cl:
            continue
        n_out = n_el = 0
        worst, outside = 0.0, []
        for (path, c), h in zip(cl, hl):
            bad, d = _leaf_diff(torch, c, h, c.dtype == torch.bfloat16)
            n_out += bad
            n_el += c.numel()
            worst = max(worst, d)
            if bad:
                outside.append(path)
            if name in loose:
                ok &= (bad <= max(2, int(TRAIN_LOOSE_FRAC * c.numel()))
                       and d <= TRAIN_LOOSE_ABS)
            else:
                ok &= bad == 0
        out[name] = {"leaves": len(cl), "elements": n_el, "outside": n_out,
                     "max_abs_diff": worst, "budget": name in loose,
                     "outside_leaves": outside}
    return out, ok


def train_check(torch, np, case):
    """Part (a): ``case``'s arch at full width, cut in depth
    (:func:`train_config`), fp32 weights drawn on the card and copied to
    the host, ``steps`` train steps on the card (kernels forward) and on
    the host (plain versions) on the same tokens and frontend inputs;
    every step's loss, grad norm and the family's ``aux`` and ``mtp``, and
    every leaf of the final state compared; the kernels' launches and
    instances counted, attention's also by shape; a MoE cut's routing
    recorded on both sides (:class:`routing_recorder`): a flip passes only
    on a near-tie of the host (:func:`routing_report`), and the line names
    the leaves it moved; each side's peak host and card memory.  Returns
    the launches and the attention launches by shape."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.models.config import MOE, layer_plan
    from repro_torch.train import trainer
    from repro_torch.train.data import data_for
    from repro_torch.train.optimizer import OptConfig, init_opt_state
    from repro_torch.train.tree import leaves, tree_map

    arch, layers, B, T, steps, mb, factored, compress, seed = case
    cfg = train_config(case)
    published = get_config(arch)
    n_moe = sum(b.mlp == MOE for b in layer_plan(cfg))
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    t0 = time.perf_counter()
    card = trainer.init_train_state(cfg, gen, factored=factored,
                                    compress=compress, device="cuda")
    params = tree_map(lambda t: t.cpu(), card.params)
    host = trainer.TrainState(params, init_opt_state(params, factored),
                              tree_map(torch.zeros_like, params)
                              if compress else None)
    init_s = time.perf_counter() - t0
    step = trainer.make_train_step(
        cfg, OptConfig(lr=TRAIN_LR, warmup_steps=min(1, steps - 1),
                       total_steps=TRAIN_TOTAL, factored=factored),
        microbatches=mb, compress_grads=compress)
    data = data_for(cfg, B, T, seed=seed, device="cpu")
    batches = [data.batch_for_step(i) for i in range(steps)]
    held = ["loss", "grad_norm", "aux"] + (["mtp"] if cfg.mtp else [])

    def run(state, device):
        metrics = []
        with routing_recorder(torch) as routing:
            t = time.perf_counter()
            for b in batches:
                state, m = step(state, {k: v.to(device)
                                        for k, v in b.items()})
                metrics.append({k: float(m[k]) for k in held + ["lr"]})
            seconds = time.perf_counter() - t
        return state, metrics, seconds, routing

    with peak_memory(torch) as host_mem:
        host, host_m, host_s, host_routing = run(host, "cpu")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    with card_turn(), peak_memory(torch) as card_mem, \
            attention_shapes() as shapes:
        card, card_m, card_s, card_routing = run(card, "cuda")
    kernels = TRAIN_KERNELS[arch]
    launches = {k: ops.launches[k] for k in kernels}
    routes = {k: dict(ops.routes[k]) for k in kernels}
    expected = {k: {route: steps * mb * train_launches(cfg, k)}
                for k, route in kernels.items()}
    metric_gap = {k: max(abs(c[k] - h[k]) / max(abs(h[k]), 1e-30)
                         for c, h in zip(card_m, host_m)) for k in held}
    loose = (("params", "mu", "nu", "err") if compress
             else ("mu",) if factored else ())
    states, states_ok = _compare_states(torch, card, host, loose)
    routing = (routing_report(host_routing, card_routing, n_moe,
                              train_routing_where(n_moe, mb))
               if n_moe else None)
    # a flip on a near-tie sends a token to another expert: the leaves it
    # moves are named, not held
    flipped = bool(routing and routing["flips"])
    finite = all(np.isfinite(m["loss"]) for m in card_m)
    by_route = {k: route_counts(r) for k, r in routes.items()}
    ok = (finite and by_route == expected
          and (routing is None or routing["ok"])
          and (states_ok or flipped)
          and all(v <= TRAIN_METRIC_RTOL for v in metric_gap.values()))
    first = batches[0]
    emit({"phase": "train", "part": "card against host", "ok": ok,
          "arch": arch, "layers": layers,
          "encoder_layers": cfg.encoder_layers, "mtp": cfg.mtp,
          "cut": {f.name: [getattr(cfg, f.name), getattr(published, f.name)]
                  for f in dataclasses.fields(cfg)
                  if getattr(cfg, f.name) != getattr(published, f.name)},
          "d_model": cfg.d_model,
          "heads": [cfg.n_heads, cfg.n_kv_heads, cfg.head_dim],
          "vocab": cfg.vocab, "moe_layers": n_moe,
          "experts": [cfg.n_experts, cfg.top_k, cfg.capacity_factor],
          "batch": B, "tokens": T, "steps": steps, "microbatches": mb,
          "frames": first["enc_embeds"].shape[1] if cfg.is_encdec else 0,
          "patches": (first["vision_embeds"].shape[1]
                      if cfg.frontend == "vision" else 0),
          "optimizer": "adafactor" if factored else "adamw",
          "compress_grads": compress, "dtype": "float32",
          "params": sum(p.numel() for p in leaves(card.params)),
          "tolerance": {"metrics_rtol": TRAIN_METRIC_RTOL,
                        "state_atol": TRAIN_TOL, "state_rtol": TRAIN_TOL,
                        "budget": {"frac": TRAIN_LOOSE_FRAC,
                                   "abs": TRAIN_LOOSE_ABS}},
          "card_metrics": card_m, "host_metrics": host_m,
          "metric_rel_gap": metric_gap, "state": states,
          "routing": routing,
          "moved_by_flips": sorted({p for c in states.values()
                                    for p in c["outside_leaves"]})
          if flipped else [],
          "launches": launches, "routes": routes,
          "expected_routes": expected,
          "attention_shapes": [{"shape": list(key[:7]), "causal": key[7],
                                "scale": key[8], "launches": n}
                               for key, n in shapes.items()],
          "memory": {"host_peak_rss_bytes": host_mem.host,
                     "host_mem_total_bytes": _host_mem_total(),
                     "card_peak_allocated_bytes":
                         torch.cuda.max_memory_allocated(),
                     "card_peak_in_use_bytes": max(host_mem.card,
                                                   card_mem.card),
                     "card_total_bytes": torch.cuda.mem_get_info()[1]},
          "init_s": init_s, "host_s": host_s, "card_s": card_s})
    del card, host
    gc.collect()
    torch.cuda.empty_cache()
    if not ok:
        raise PhaseFailed(f"training on the card disagrees with the host "
                          f"({arch}, {case[5:8]}) or a kernel ran off its "
                          f"instance")
    return launches, shapes


def _launcher(args, tmp, name):
    """``python -m repro_torch.launch.train`` at the full size, with
    ``args``, from the root of this checkout: its report, wall and
    output."""
    ck, rep = tmp / f"ckpt_{name}", tmp / f"{name}.json"
    cmd = [sys.executable, "-m", "repro_torch.launch.train", "--arch",
           TRAIN_ARCH, "--steps", str(TRAIN_STEPS), "--batch",
           str(TRAIN_BATCH), "--seq", str(TRAIN_SEQ), "--ckpt-every",
           str(TRAIN_CKPT_EVERY), "--ckpt-dir", str(ck), "--report",
           str(rep), *args]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True,
                            env=_cli_env(), cwd=str(ROOT)), ck, rep


def _finish(proc, ck, rep, t0, timeout=600):
    import shutil

    try:
        out, err = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.communicate()
        raise PhaseFailed("the training launcher did not end in time")
    wall = time.perf_counter() - t0
    shutil.rmtree(ck, ignore_errors=True)
    if proc.returncode != 0:
        raise PhaseFailed(f"the training launcher failed "
                          f"({proc.returncode}): {err[-3000:]}")
    report = json.loads(rep.read_text())
    report.update(wall_s=wall, stdout=out.strip().splitlines())
    return report


def traced_train_step(torch):
    """One launcher-sized step of TRAIN_ARCH in this process after one
    untraced step, under the device trace: the step's wall, the card's
    busy share and the port's kernels' seconds."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.train.data import data_for
    from repro_torch.train.optimizer import OptConfig
    from repro_torch.train.trainer import init_train_state, make_train_step

    cfg = get_config(TRAIN_ARCH)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    state = init_train_state(cfg, gen, device="cuda")
    step = make_train_step(cfg, OptConfig(
        lr=3e-4, warmup_steps=5, total_steps=TRAIN_STEPS))
    data = data_for(cfg, TRAIN_BATCH, TRAIN_SEQ, device="cuda")
    state, _ = step(state, data.batch_for_step(0))
    batch = data.batch_for_step(1)
    torch.cuda.synchronize()
    gc.collect()            # this process's heap is large by now
    ops.reset_launches()
    prof, trace_error = start_device_trace(torch)
    t0 = time.perf_counter()
    state, m = step(state, batch)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    busy = stop_device_trace(prof, trace_error, wall)
    busy["wall_s"] = wall
    busy["launches"] = {"flash_attention": ops.launches["flash_attention"]}
    port = sum((busy.get("port_kernels_s") or {}).values())
    if busy.get("busy_s"):
        busy["port_kernels_share"] = port / wall
        busy["port_kernels_share_of_busy"] = port / busy["busy_s"]
    del state, m, prof
    torch.cuda.empty_cache()
    return busy


def train_families(torch, np):
    """The checks of (a) for TRAIN_PART_ARCHS, as a part of their own at
    TRAIN_PART_NICE: their launches (``"arch:kernel"``) and attention
    launches by shape, by arch."""
    os.nice(TRAIN_PART_NICE)
    torch.set_num_threads(max(1, (os.cpu_count() or 2) // 2))
    launches, shapes = Counter(), {}
    for case in TRAIN_CHECKS:
        if case[0] in TRAIN_PART_ARCHS:
            got, shapes[case[0]] = train_check(torch, np, case)
            launches.update({f"{case[0]}:{k}": v for k, v in got.items()})
    return launches, shapes


def phase_train(torch, np, families):
    """Phase 9: (b) the launcher at full size, clean, alone; one traced
    step; then (b)'s run with failures in the background while (a) holds
    the card's training against the host's (but for TRAIN_PART_ARCHS,
    whose checks ran as a part: ``families`` is what
    :func:`train_families` returned)."""
    import shutil
    import tempfile

    from repro_torch.configs import get_config
    from repro_torch.models.config import layer_plan

    cfg = get_config(TRAIN_ARCH)
    tokens = TRAIN_BATCH * TRAIN_SEQ
    n_params = cfg.param_count()
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_train_"))
    try:
        proc, ck, rep = _launcher([], tmp, "clean")
        clean = _finish(proc, ck, rep, time.perf_counter())
        trace = traced_train_step(torch)
        t0 = time.perf_counter()
        faulty_proc, fck, frep = _launcher(
            ["--inject-failures", ",".join(map(str, TRAIN_FAILURES))], tmp,
            "faulty")
        check_launches, check_shapes = Counter(families[0]), families[1]
        threads = torch.get_num_threads()
        # leave the launcher's process a core or two for its dispatch
        torch.set_num_threads(max(1, (os.cpu_count() or 2) - 2))
        try:
            for case in TRAIN_CHECKS:
                if case[0] in TRAIN_PART_ARCHS:
                    continue
                launches, _ = train_check(torch, np, case)
                for k, v in launches.items():
                    check_launches[f"{case[0]}:{k}"] += v
        except BaseException:
            faulty_proc.kill()
            faulty_proc.communicate()
            raise
        finally:
            torch.set_num_threads(threads)
        faulty = _finish(faulty_proc, fck, frep, t0)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    steady = clean["step_s"][1:]
    ms = float(np.median(steady)) * 1e3
    att = clean["launches"]["flash_attention"]
    per_step = att / len(clean["step_s"])
    n_attn = sum(b.kind in _KINDS["flash_attention"]
                 for b in layer_plan(cfg))
    gap = abs(faulty["losses"][-1] - clean["losses"][-1])
    rel_gap = gap / abs(clean["losses"][-1])
    # the bound: 8 flops a parameter a token (forward, remat recompute,
    # backward), plus causal attention's 8 B H T^2 hd a layer, at FP32
    matmul_flops = 8 * n_params * tokens
    attn_flops = 8 * TRAIN_BATCH * cfg.n_heads * TRAIN_SEQ ** 2 \
        * cfg.head_dim * n_attn
    bound_s = (matmul_flops + attn_flops) / FP32_OPS_PER_S
    ok = (clean["n_restarts"] == 0 and clean["final_step"] == TRAIN_STEPS
          and all(np.isfinite(x) for x in clean["losses"])
          and faulty["n_restarts"] == 2
          and faulty["restored_from"] == [4, 8]
          and faulty["final_step"] == TRAIN_STEPS
          and rel_gap <= TRAIN_LOSS_RTOL
          and route_counts(clean["routes"]["flash_attention"])
          == {"tf32x3": att}
          and per_step == 2 * n_attn)
    emit({"phase": "train", "part": "launcher", "ok": ok,
          "arch": TRAIN_ARCH, "layers": cfg.n_layers, "d_model": cfg.d_model,
          "heads": [cfg.n_heads, cfg.n_kv_heads, cfg.head_dim],
          "vocab": cfg.vocab, "tie_embeddings": cfg.tie_embeddings,
          "param_count": n_params, "dtype": "float32", "optimizer": "adamw",
          "steps": TRAIN_STEPS, "batch": TRAIN_BATCH, "seq": TRAIN_SEQ,
          "ckpt_every": TRAIN_CKPT_EVERY,
          "inject_failures": list(TRAIN_FAILURES),
          "clean": {k: clean[k] for k in (
              "stdout", "losses", "step_s", "wall_s", "peak_bytes",
              "launches", "routes", "n_restarts", "final_step")},
          "faulty": {k: faulty[k] for k in (
              "stdout", "losses", "restored_from", "n_restarts",
              "final_step", "wall_s", "peak_bytes")},
          "final_loss_gap": gap, "final_loss_rel_gap": rel_gap,
          "final_loss_equal": faulty["losses"][-1] == clean["losses"][-1],
          "loss_rtol": TRAIN_LOSS_RTOL,
          "first_step_s": clean["step_s"][0], "ms_per_step": ms,
          "tokens_per_s": tokens / ms * 1e3,
          "attention_launches_per_step": per_step,
          "expected_attention_launches_per_step": 2 * n_attn,
          "bound_s": bound_s, "bound_by": "operations (FP32 67 TFLOP/s)",
          "bound_flops": {"matmul": matmul_flops, "attention": attn_flops},
          "traced_step": trace, "check_launches": dict(check_launches)})
    if not ok:
        raise PhaseFailed("the training launcher's runs disagree, did not "
                          "restart as injected, or launched attention off "
                          "its instance")
    return {"flash_attention": {"launches": att, "per_step": per_step,
                                "routes": clean["routes"]["flash_attention"],
                                "shape": [TRAIN_BATCH, TRAIN_SEQ,
                                          cfg.n_heads, cfg.n_kv_heads,
                                          cfg.head_dim]},
            "checks": dict(check_launches), "check_shapes": check_shapes,
            "step": {"ms": ms, "peak_bytes": clean["peak_bytes"],
                     "bound_s": bound_s}}


def prefill_function(functions, instance, q, v):
    """The ptxas entry (registers, spills) of the kernel function an fp32
    prefill instance launches, ``instance`` named as ``ops.routes`` counts
    it (the CUDA-core one's template arguments as csrc/attention.cu picks
    them)."""
    if instance.startswith("tf32x3<"):
        nacc, keys, rows = instance[len("tf32x3<"):-1].split(",")
        return ptxas_of(functions, f"attn_tf32x3_kernelILi{nacc}ELi{keys}"
                                   f"ELi{rows}E")
    types = "".join("13__nv_bfloat16" if t.element_size() == 2 else "f"
                    for t in (q, v))
    hdv = v.shape[-1]
    nacc = 16 if hdv <= 64 else 32 if hdv <= 128 else 64
    return ptxas_of(functions, f"attn_kernelI{types}Li{nacc}E")


def train_attention_fields(torch, functions, B, Tq, Tk, H, Hkv, hd, hdv,
                           causal, scale):
    """flash attention at a shape of the training path (fp32: the
    ``tf32x3`` instance), against its plain version and SDPA (the backend
    it took named), timed with both and with the ``cuda_cores`` instance
    that took fp32 before it (forced, on the same inputs), beside two
    bounds: FP32 67 TFLOP/s, and the three TF32 products of 3xTF32 at 495
    TFLOP/s; each instance's registers and spills."""
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import (
        attention_instance, flash_attention_cuda, flash_attention_plain)

    gen = torch.Generator(device="cuda")
    gen.manual_seed(22)
    q = _randn(torch, gen, (B, Tq, H, hd), torch.float32)
    k = _randn(torch, gen, (B, Tk, Hkv, hd), torch.float32)
    v = _randn(torch, gen, (B, Tk, Hkv, hdv), torch.float32)
    kw = dict(causal=causal, scale=scale)
    got = flash_attention_cuda(q, k, v, **kw)
    old = flash_attention_cuda(q, k, v, route="cuda_cores", **kw)
    want = flash_attention_plain(q, k, v, **kw)
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    sdpa_kw = dict(is_causal=causal, scale=scale, enable_gqa=H != Hkv)

    def sdpa():
        return F.scaled_dot_product_attention(qt, kt, vt, **sdpa_kw)
    backend = sdpa_backend(torch, qt, kt, vt, **sdpa_kw)
    n_bytes = 4 * B * (Tq * H * (hd + hdv) + Tk * Hkv * (hd + hdv))
    n_ops = 2 * (hd + hdv) * H * B * attention_pairs(Tq, Tk, causal, 0)
    bound, by = bound_ms(n_bytes, n_ops, FP32_OPS_PER_S)
    bound3, by3 = bound_ms(n_bytes, 3 * n_ops, TF32_TC_OPS_PER_S)
    instance = attention_instance(q, k, v)
    return {"instance": instance,
            "function": prefill_function(functions, instance, q, v),
            "shape": [B, Tq, H, Hkv, hd] + ([hdv] if hdv != hd else [])
            + ([Tk] if Tk != Tq else []),
            "causal": causal, "scale": scale, "dtype": "float32",
            "max_abs_err": _err(got, want),
            "library_max_abs_diff": _err(got, sdpa().transpose(1, 2)),
            "ms": device_ms(torch, lambda: flash_attention_cuda(
                q, k, v, **kw), 10),
            "cuda_cores_ms": device_ms(torch, lambda: flash_attention_cuda(
                q, k, v, route="cuda_cores", **kw), 10),
            "cuda_cores_max_abs_err": _err(old, want),
            "cuda_cores_function": prefill_function(functions, "cuda_cores",
                                                    q, v),
            "plain_ms": device_ms(torch, lambda: flash_attention_plain(
                q, k, v, **kw), 2),
            "library": "F.scaled_dot_product_attention", **backend,
            "library_ms": device_ms(torch, sdpa, 10),
            "bound_ms": bound, "bound_by": by,
            "bound_rate": "FP32 67 TFLOP/s; HBM 3.35 TB/s",
            "bound_ms_tf32x3": bound3, "bound_by_tf32x3": by3,
            "bound_rate_tf32x3": "3 x the operations at TF32 495 TFLOP/s; "
                                 "HBM 3.35 TB/s"}


def add_train_fields(torch, entries, trained, functions):
    """Each model kernel's launches on the training path beside its
    serving ones: attention's in the launcher's clean run (phase 9 (b)),
    with its time at that shape, and at each shape the checks of
    TRAIN_PART_ARCHS launched it in (a), with its launches there; each
    recurrence's chunked route's in its arch's check (phase 9 (a)).
    Returns whether the training instances agree with the plain version
    and were launched."""
    by_name = {"rglru_scan": f"{RG}:rglru_scan", "wkv6": f"{RWKV}:wkv6"}

    def good(f):      # both fp32 instances agree, the tf32x3 one was timed
        return (f["instance"].startswith("tf32x3<")
                and f["max_abs_err"] <= TOL["float32"]
                and f["cuda_cores_max_abs_err"] <= TOL["float32"])
    ok = True
    for e in entries:
        if e["name"] == "flash_attention":
            att = trained["flash_attention"]
            B, T, H, Hkv, hd = att["shape"]
            e["train"] = dict(att, **train_attention_fields(
                torch, functions, B, T, T, H, Hkv, hd, hd, True, None))
            ok &= good(e["train"]) and att["launches"] > 0
            e["train_checks"] = {}
            for arch in TRAIN_PART_ARCHS:
                shapes = trained["check_shapes"].get(arch, {})
                e["train_checks"][_SUB_ENTRY[arch]] = fields = [
                    dict(launches=n, where="phase 9 (a)",
                         **train_attention_fields(torch, functions, *key))
                    for key, n in shapes.items()]
                ok &= bool(fields) and all(good(f) for f in fields)
        elif e["name"] in by_name and e.get("instance") == "chunked":
            e["train"] = {"launches": trained["checks"].get(
                by_name[e["name"]], 0), "route": "chunked",
                "where": "phase 9 (a)"}
            ok &= e["train"]["launches"] > 0
    return ok


# --------------------------------------------------------------------------- #
# phase 10: the dry run                                                        #
# --------------------------------------------------------------------------- #
DRYRUN_MESHES = ("single", "multi")
# (b): the dry run's job mix on the card and on the host
TPU_JOBS, TPU_NODES, TPU_LOAD, TPU_SEED = 200, 128, 0.7, 0
TPU_POLICY = "GreedyP */OPT=MIN"
# (c): the decode steps of phase 7 it bounds (DeepSeek-V3's cut serve
# aside); a measured step may not beat 0.95 x its bound, and the measured
# peak must lie within 0.5-2 x the dry run's bytes a device
BOUND_ARCHS = (RG, RWKV, LLAMA, QWEN_MOE, WHISPER, INTERNVL)
STEP_FLOOR = 0.95
MEMORY_BAND = (0.5, 2.0)


def _dryrun_arch(arch):
    """Phase 10 (a)'s job for one arch, in a host pool worker: ``python -m
    repro_torch.launch.dryrun --arch <arch> --shape <s> --mesh both`` for
    every shape (its ``main``, its printing kept off this script's
    output); (records, exit codes, seconds)."""
    import contextlib
    import io
    import tempfile

    _src_on_path()
    from repro_torch.configs import SHAPES
    from repro_torch.launch import dryrun

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as out:
        with contextlib.redirect_stdout(io.StringIO()):
            rcs = [dryrun.main(["--arch", arch, "--shape", s, "--mesh",
                                "both", "--out", out]) for s in SHAPES]
        recs = []
        for path in sorted(Path(out).glob("*.json")):
            with open(path) as f:
                recs.append(json.load(f))
    return recs, rcs, time.perf_counter() - t0


def dryrun_check(results, pool_wall):
    """Phase 10 (a)'s line: every (arch, shape, mesh) cell ``ok``, or
    ``skipped`` exactly where ``shape_applicable`` says; each cell's
    bottleneck, terms and GiB a device.  Returns the records."""
    from repro_torch.configs import ARCHS, SHAPES, get_config, \
        shape_applicable
    from repro_torch.launch.roofline import bytes_per_chip

    records = [r for recs, _, _ in results for r in recs]
    got = {(r["arch"], r["shape"], r["mesh"]): r for r in records}
    want = {(a, sh, m): shape_applicable(get_config(a), SHAPES[sh])[0]
            for a in ARCHS for sh in SHAPES for m in DRYRUN_MESHES}
    ok = (set(got) == set(want) and len(records) == len(want)
          and all(rc == 0 for _, rcs, _ in results for rc in rcs)
          and all(got[k]["status"] == ("ok" if v else "skipped")
                  for k, v in want.items()))
    cells = []
    for (a, sh, m), r in sorted(got.items()):
        cell = {"cell": f"{a}:{sh}:{m}", "status": r["status"]}
        if r["status"] == "ok":
            t = r["roofline"]
            cell.update(bottleneck=t["bottleneck"], compute_s=t["compute_s"],
                        memory_s=t["memory_s"],
                        collective_s=t["collective_s"],
                        gib_per_device=bytes_per_chip(r) / 2 ** 30,
                        trace_s=r["trace_s"])
        cells.append(cell)
    emit({"phase": "dryrun", "part": "a", "ok": ok, "records": len(records),
          "expected": len(want), "pool_wall_s": pool_wall,
          "job_s": {a: secs for a, (_, _, secs) in zip(ARCHS, results)},
          "cells": cells})
    if not ok:
        raise PhaseFailed("a dry-run cell failed, is missing, or was skipped "
                          "where its shape applies")
    return records


def phase_dryrun_tpu(torch, np, records):
    """Phase 10 (b): the single-mesh records through
    ``launch.roofline.jobgen_records`` into the ``tpu`` kind (200 jobs,
    128 nodes, load 0.7, seed 0), simulated under GreedyP */OPT=MIN by
    ``run_batched`` on the card (the solve kernel) and by the host numpy
    ``Engine``, every outcome field equal."""
    import tempfile

    from repro_torch.launch.roofline import jobgen_records
    from repro_torch.sched.sweep import Cell
    from repro_torch.workloads.jobgen import tpu_job_types
    from repro_torch.workloads.registry import WorkloadSpec

    with tempfile.TemporaryDirectory() as tmp:
        for r in records:
            if r["mesh"] == "single":
                name = f"{r['arch']}__{r['shape']}__single.json"
                with open(os.path.join(tmp, name), "w") as f:
                    json.dump(r, f)
        flat = jobgen_records("single", tmp)
        path = os.path.join(tmp, "records.json")
        with open(path, "w") as f:
            json.dump(flat, f)
        w = WorkloadSpec("tpu", n_jobs=TPU_JOBS, n_nodes=TPU_NODES,
                         seed=TPU_SEED, load=TPU_LOAD,
                         params={"records": path})
        cells = [Cell(w, TPU_POLICY)]
        run = drive_cells(torch, np, cells)
        checked = check_cells(np, run, cells, [_host_cell(cells[0])], 0.0)
    types = tpu_job_types(flat)
    ok = not checked["mismatches"] and run["launches"]["maxmin_solve"] > 0
    rec = run["res"].records[0]
    emit({"phase": "dryrun", "part": "b", "ok": ok, "records": len(flat),
          "job_types": [{"name": t.name, "cpu_need": t.cpu_need,
                         "mem_req": t.mem_req, "n_tasks": t.n_tasks}
                        for t in types],
          "n_jobs": TPU_JOBS, "n_nodes": TPU_NODES, "load": TPU_LOAD,
          "seed": TPU_SEED, "policy": TPU_POLICY,
          "launches": run["launches"], "mismatches": checked["mismatches"],
          "max_stretch": rec["max_stretch"],
          "host_max_stretch": checked["host_results"][0].max_stretch,
          "host_wall_s": checked["host_walls"][0], **run["line"]})
    if not ok:
        raise PhaseFailed("the dry run's tpu trace disagrees between the "
                          "card and the host, or the solve kernel did not "
                          "launch")


def phase_dryrun_bounds(torch, served, trained):
    """Phase 10 (c): the dry run of the very steps phases 7 and 9 timed, on
    a one-device plan (a (1, 1) mesh; the inputs' peak: bf16 989 TFLOP/s
    for the serves, FP32 67 TFLOP/s for the fp32 training), against the
    card: measured / bound (a step faster than 0.95 x its bound means a
    wrong count), the measured peak against the dry run's bytes a device
    (within 0.5-2x), the dry run's memory term beside the hand-worked
    weight read of PERF.md section 5 (and phase 9's hand-worked bound)."""
    from repro_torch.configs import ShapeSpec, get_config
    from repro_torch.launch import dryrun, roofline
    from repro_torch.launch.mesh import Mesh

    one = Mesh(("data", "model"), (1, 1))
    t0 = time.perf_counter()
    steps = []

    def row(name, rec, measured_s, peak, hand):
        t = rec["roofline"]
        nbytes = roofline.bytes_per_chip(rec)
        out = {"step": name, "measured_s": measured_s,
               "bound_s": t["step_s"], "bottleneck": t["bottleneck"],
               "compute_s": t["compute_s"], "memory_s": t["memory_s"],
               "measured_over_bound": measured_s / t["step_s"],
               "dryrun_bytes": nbytes, "peak_bytes": peak,
               "peak_over_dryrun": peak / nbytes, **hand,
               "kernels": {k: v["calls"] for k, v in rec["kernels"].items()}}
        out["ok"] = (measured_s >= STEP_FLOOR * t["step_s"]
                     and MEMORY_BAND[0] <= out["peak_over_dryrun"]
                     <= MEMORY_BAND[1])
        steps.append(out)

    for arch in BOUND_ARCHS:
        m = served[arch][3]
        shape = ShapeSpec("serve_decode", m["cache_len"], SERVE_SLOTS,
                          "decode")
        rec = dryrun.trace_cell(m["cfg"], shape, one,
                                knobs={"dtype": torch.bfloat16},
                                hw=roofline.HW(chips=1), extrap=False)
        row(f"{arch} decode ({m['cfg'].n_layers} layers, {SERVE_SLOTS} "
            f"slots, cache {m['cache_len']})", rec,
            m["ms_per_decode_step"] / 1e3, m["peak_bytes"],
            {"hand_weight_read_ms": m["weight_read_bound_ms"],
             "dryrun_memory_ms": rec["roofline"]["memory_s"] * 1e3})
    t = trained["step"]
    shape = ShapeSpec("train_step", TRAIN_SEQ, TRAIN_BATCH, "train")
    rec = dryrun.trace_cell(get_config(TRAIN_ARCH), shape, one,
                            knobs={"dtype": torch.float32, "factored": False},
                            hw=roofline.HW(chips=1,
                                           peak_flops=FP32_OPS_PER_S),
                            extrap=False)
    row(f"{TRAIN_ARCH} train ({TRAIN_BATCH} x {TRAIN_SEQ}, fp32, AdamW)",
        rec, t["ms"] / 1e3, t["peak_bytes"],
        {"hand_bound_s": t["bound_s"],
         "dryrun_compute_s": rec["roofline"]["compute_s"],
         "dryrun_memory_ms": rec["roofline"]["memory_s"] * 1e3})
    ok = all(r["ok"] for r in steps)
    emit({"phase": "dryrun", "part": "c", "ok": ok,
          "hw": "one device: bf16 989 TFLOP/s (serves), FP32 67 TFLOP/s "
                "(training), HBM 3.35 TB/s", "step_floor": STEP_FLOOR,
          "memory_band": list(MEMORY_BAND), "steps": steps,
          "trace_s": time.perf_counter() - t0})
    if not ok:
        raise PhaseFailed("a measured step beat its dry-run bound, or a "
                          "measured peak lies outside 0.5-2x the dry run's "
                          "bytes a device")


# --------------------------------------------------------------------------- #
# the parts: phases 4-4e, 10 (a) and 9 (a)'s families, a process each        #
# --------------------------------------------------------------------------- #
def _part_slice(torch, np):
    launches, stats, seed0 = phase_slice(torch, np)
    return launches, stats, phase_slice_serve(torch, np, seed0)


def _part_dryrun(torch, np):
    from repro_torch.configs import ARCHS

    return host_check(_dryrun_arch, ARCHS, dryrun_check)


#: name -> fn(torch, np), in phase order; what it returns is picklable
PARTS = {"slice": _part_slice, "slice mcb8": phase_slice_mcb8,
         "slice session": phase_slice_session,
         "slice scenarios grid": scenarios_grid,
         "slice scenarios sessions": scenarios_sessions,
         "dryrun": _part_dryrun, "train families": train_families}
#: environment added to a part's process (read as its OpenMP runtime
#: loads): the families' threads sleep when idle, not spin on the cores
#: the other parts use
PART_ENV = {"train families": {"OMP_WAIT_POLICY": "PASSIVE"}}


class card_turn:
    """Within its block, this process has the card's memory to itself
    among the parts: an exclusive lock on the file ``run_parts`` names in
    ``CHIP_SMOKE_CARD_LOCK`` (no lock outside ``run_parts``).  The
    families' card steps (50-74 GB of the card's 80 at their optimizer
    step) and the kill -9 drill, whose restarted server process allocates
    afresh, take turns under it, so the drill's server never meets a
    nearly full card."""

    def __enter__(self):
        import fcntl
        path = os.environ.get("CHIP_SMOKE_CARD_LOCK")
        self.f = open(path, "w") if path else None
        if self.f:
            fcntl.flock(self.f, fcntl.LOCK_EX)
        return self

    def __exit__(self, *exc):
        if self.f:
            self.f.close()          # closing releases the lock


def run_parts():
    """Starts ``chip_smoke.py --part <name>`` for every part of
    :data:`PARTS`, all together, each with its lines and errors going to
    files; waits for each in phase order and prints its lines and errors
    once it has ended.  Returns each part's result by name, or raises
    :class:`PhaseFailed` naming the parts that failed, once all have
    ended.  No part outlives the call."""
    import pickle
    import tempfile

    results, failed, procs = {}, [], {}
    with tempfile.TemporaryDirectory() as tmp:
        lock = {"CHIP_SMOKE_CARD_LOCK": os.path.join(tmp, "card.lock")}
        try:
            for i, name in enumerate(PARTS):
                base = os.path.join(tmp, str(i))
                with open(base + ".out", "w") as out, \
                        open(base + ".err", "w") as err:
                    procs[name] = (base, subprocess.Popen(
                        [sys.executable, str(Path(__file__).resolve()),
                         "--part", name, "--result", base + ".pkl",
                         "--start", repr(_START)],
                        stdout=out, stderr=err, cwd=ROOT,
                        env={**os.environ, **lock,
                             **PART_ENV.get(name, {})}))
            for name, (base, proc) in procs.items():
                rc = proc.wait()
                sys.stdout.write(Path(base + ".out").read_text())
                sys.stdout.flush()
                sys.stderr.write(Path(base + ".err").read_text())
                sys.stderr.flush()
                if rc != 0:
                    failed.append(f"{name} (exit code {rc})")
                    continue
                with open(base + ".pkl", "rb") as f:
                    results[name] = pickle.load(f)
        finally:
            for _, proc in procs.values():
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
    if failed:
        raise PhaseFailed(f"a part failed: {', '.join(failed)}")
    return results


def run_part(name, result_path, start):
    """One part of :data:`PARTS` in this process, its phase lines timed
    from the script's ``start``; its result pickled to ``result_path``.
    Returns the exit code."""
    import pickle

    import numpy as np
    import torch

    global _START
    _START = start
    sys.path.insert(0, str(ROOT / "src"))
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        out = PARTS[name](torch, np)
    except Exception as exc:  # noqa: BLE001 — reported, then a failing exit
        traceback.print_exc()
        emit({"phase": name, "ok": False,
              "error": f"{type(exc).__name__}: {exc}"})
        return 1
    with open(result_path, "wb") as f:
        pickle.dump(out, f)
    return 0


def main() -> int:
    if sys.argv[1:2] == ["--part"]:
        import argparse

        ap = argparse.ArgumentParser()
        ap.add_argument("--part", choices=list(PARTS), required=True)
        ap.add_argument("--result", required=True)
        ap.add_argument("--start", type=float, required=True)
        args = ap.parse_args()
        return run_part(args.part, args.result, args.start)

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
        usage_paper = phase_kernels(torch, np)
        phase = "allocator"
        phase_allocator(torch, np)
        phase = "parts"
        parts = run_parts()
        launches, stats, serve_launches = parts["slice"]
        session_launches = parts["slice session"]
        phase = "slice scenarios"
        scenario_launches = scenarios_check(
            parts["slice scenarios grid"], parts["slice scenarios sessions"])
        dry_records = parts["dryrun"]
        phase = "serve kernels"
        phase_serve_kernels(torch)
        for arch, spec in {**SERVE_ARCHS, **CHECK_ARCHS}.items():
            phase = f"model check {arch}"
            phase_model_check(torch, np, arch, spec)
        served = {}
        for arch in SERVE_ARCHS:
            phase = f"serve {arch}"
            served[arch] = phase_serve(torch, np, arch)
        phase = "train"
        trained = phase_train(torch, np, parts["train families"])
        phase = "dryrun tpu"
        phase_dryrun_tpu(torch, np, dry_records)
        phase = "dryrun bounds"
        phase_dryrun_bounds(torch, served, trained)
        phase = "kernels line"
        alloc_entries, alloc_ok = phase_kernel_line(
            torch, np, launches, stats, libraries["alloc"]["ptxas"],
            session_launches, scenario_launches, serve_launches,
            usage_paper)
        serve_entries, serve_ok = serve_kernel_entries(
            torch, np, served, libraries["attention"]["ptxas"], hgmma,
            libraries["rglru"]["ptxas"])
        wkv, wkv_ok = wkv6_entries(torch, np, *served[RWKV][:3],
                                   libraries["wkv6"]["ptxas"])
        line = {"kernels": alloc_entries + serve_entries + wkv}
        train_ok = add_train_fields(torch, line["kernels"], trained,
                                    libraries["attention"]["ptxas"])
        ok = alloc_ok and serve_ok and wkv_ok and train_ok
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
