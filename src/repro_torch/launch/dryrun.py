"""Dry run of every (arch x shape x mesh) cell: the step traced on
``meta`` (a port of the JAX package's ``launch/dryrun.py``).

For each cell the step (train step / prefill / decode) runs on ``meta``
tensors under :class:`repro_torch.launch.cost.CostTrace` — shapes only: no
data, no device, no CPU arrays — with the production sharding plan of the
mesh, and the record (memory a device, FLOPs, bytes, the
collective traffic the plan adds, the roofline terms) is written to
``experiments/dryrun_torch/<arch>__<shape>__<mesh>.json``.  Its keys are
the reference's where ``benchmarks/roofline.py`` reads them; the README
lists the differences (``trace_s`` for ``lower_s`` / ``compile_s``, the
``hw`` constants, ...).  ``launch.roofline.jobgen_records`` turns the
records into the ``tpu`` workload kind's.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch llama3-8b \\
        --shape train_4k --mesh single
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both

The reference compiles the scanned program for memory and extrapolates
costs from unrolled shallow variants, because XLA counts a loop body once.
The port has no scan, and its single-mesh pass traces 1-2 periods of the
layer pattern (plus the prefix, the encoder and a partial period), never
all 61 of DeepSeek-V3's layers: the extrapolation gives a full-depth
trace's counts and temporaries (on the 32 full-size single-pod cells, all
equal but DeepSeek-V3's train bytes, within 1.2e-8).  The multi-pod pass, as the
reference's compile-only one, traces the full depth once.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
from typing import Any, Dict, List, Optional, Tuple

import torch

from ..configs import ALIASES, ARCHS, SHAPES, ShapeSpec, get_config, \
    shape_applicable
from ..models import backbone, moe
from ..models.config import ModelConfig
from ..train.optimizer import OptConfig
from ..train.trainer import init_train_state, make_train_step
from ..train.tree import leaves
from . import mesh as meshmod
from . import roofline
from .cost import CostTrace, plan_collectives
from .mesh import Mesh
from .shardings import Plan, device_bytes, make_plan

DEFAULT_OUT = roofline.DRYRUN_DIR

# Per-cell knobs (microbatches for train; compute dtype); ``--set`` adds
# to ("*", "*").
PRESETS: Dict[Tuple[str, str], Dict[str, Any]] = {}

_META = torch.device("meta")


def preset(arch: str, shape: str) -> Dict[str, Any]:
    base = {"microbatches": 1, "dtype": torch.bfloat16, "sp": True,
            "fsdp": None, "ep": None, "ep2": None, "remat": True,
            "factored": None, "kv_int8": False}
    base.update(PRESETS.get(("*", "*"), {}))
    base.update(PRESETS.get((arch, shape), {}))
    return base


# --------------------------------------------------------------------------- #
# input specs                                                                  #
# --------------------------------------------------------------------------- #
def batch_shapes(cfg: ModelConfig, B: int, T: int) -> Dict[str, torch.Tensor]:
    out = {"tokens": torch.empty((B, T), dtype=torch.int32, device=_META)}
    if cfg.is_encdec:
        out["enc_embeds"] = torch.empty((B, 1500, cfg.d_model),
                                        dtype=torch.bfloat16, device=_META)
    if cfg.frontend == "vision":
        nv = min(cfg.n_frontend_tokens or 256, T // 2)
        out["vision_embeds"] = torch.empty((B, nv, cfg.d_model),
                                           dtype=torch.bfloat16,
                                           device=_META)
    return out


def auto_factored(cfg: ModelConfig) -> bool:
    """Adafactor moments for >=100B-param models (the memory fit)."""
    return cfg.param_count() > 1e11


def input_specs(arch: str, shape_name: str, *, dtype=torch.bfloat16,
                factored: Optional[bool] = None):
    """``meta`` stand-ins for every model input of one cell: shapes and
    dtypes, no allocation."""
    return input_specs_for(get_config(arch), shape_name, dtype=dtype,
                           factored=factored)


def _shape(shape) -> ShapeSpec:
    return SHAPES[shape] if isinstance(shape, str) else shape


def input_specs_for(cfg: ModelConfig, shape, *, dtype=torch.bfloat16,
                    factored: Optional[bool] = None, kv_int8: bool = False):
    """As :func:`input_specs`, for a config and a shape (a ``SHAPES`` name
    or a ``ShapeSpec``): the train state (training layout) and the batch;
    or the parameters, the batch and the caches (reference layout,
    ``S_enc`` 1,500 for an encoder-decoder, int8 attention KV under
    ``kv_int8``) of a prefill; or the parameters, one token a request,
    the caches and a 0-d position of a decode."""
    shape = _shape(shape)
    B, T = shape.global_batch, shape.seq_len
    cache_dtype = torch.int8 if kv_int8 else dtype
    if shape.kind == "train":
        fact = auto_factored(cfg) if factored is None else factored
        state = init_train_state(cfg, torch.Generator(), dtype=dtype,
                                 factored=fact, device=_META)
        return {"state": state, "batch": batch_shapes(cfg, B, T)}
    params = backbone.param_shapes(cfg, dtype)
    caches = backbone.cache_shapes(cfg, B, T,
                                   S_enc=1500 if cfg.is_encdec else 0,
                                   dtype=cache_dtype)
    if shape.kind == "prefill":
        return {"params": params, "batch": batch_shapes(cfg, B, T),
                "caches": caches}
    return {"params": params,
            "tokens": torch.empty((B,), dtype=torch.int32, device=_META),
            "caches": caches,
            "pos": torch.empty((), dtype=torch.int32, device=_META)}


# --------------------------------------------------------------------------- #
# step builders                                                                #
# --------------------------------------------------------------------------- #
def build_step(cfg: ModelConfig, shape, plan: Plan, knobs):
    """(fn, args, in_specs, out_specs, donate) for the cell; sets the MoE
    routing groups to the plan's (callers reset them to 1)."""
    shape = _shape(shape)
    # resolve ``factored`` against the FULL config once so the shallow
    # extrapolation points build the same optimizer-state structure
    fact = knobs.get("factored")
    if fact is None:
        fact = auto_factored(get_config(cfg.name))
    specs = input_specs_for(cfg, shape, dtype=knobs["dtype"],
                            factored=fact, kv_int8=knobs.get("kv_int8", False))
    moe.set_groups(plan.moe_groups())

    pspecs = plan.param_specs()
    if shape.kind == "train":
        fn = make_train_step(cfg, OptConfig(factored=fact),
                             microbatches=knobs["microbatches"],
                             remat=knobs["remat"])
        state = specs["state"]
        state_sh = plan.train_state_specs(state, fact)
        in_sh = (state_sh, plan.batch_specs(specs["batch"]))
        return fn, (state, specs["batch"]), in_sh, (state_sh, None), (0,)
    csh = plan.cache_specs(specs["caches"])
    if shape.kind == "prefill":
        @torch.no_grad()
        def fn(params, batch, caches):
            logits, _ = backbone.prefill(cfg, params, batch,
                                         backbone.layer_params(cfg, caches))
            return logits, caches
        in_sh = (pspecs, plan.batch_specs(specs["batch"]), csh)
        args = (specs["params"], specs["batch"], specs["caches"])
        return fn, args, in_sh, (None, csh), (2,)

    @torch.no_grad()
    def fn(params, tokens, caches, pos):
        logits, _ = backbone.decode_step(cfg, params, tokens,
                                         backbone.layer_params(cfg, caches),
                                         pos)
        return logits, caches
    tok_sh = plan.batch_specs({"tokens": specs["tokens"]})["tokens"]
    in_sh = (pspecs, tok_sh, csh, ())
    args = (specs["params"], specs["tokens"], specs["caches"], specs["pos"])
    return fn, args, in_sh, (None, csh), (2,)


# --------------------------------------------------------------------------- #
# one trace                                                                    #
# --------------------------------------------------------------------------- #
def _trace(cfg: ModelConfig, shape: ShapeSpec, plan: Plan, knobs) -> Dict:
    """One traced step of ``cfg`` under ``plan``: per-device costs (the
    trace's global counts over the mesh's devices), the plan's
    collectives, the temporaries a device holds, each kernel's charges."""
    try:
        fn, args, _, _, _ = build_step(cfg, shape, plan, knobs)
        with CostTrace() as tr:
            out = fn(*args)
    finally:
        moe.set_groups(1)
    chips = plan.mesh.size
    kind = shape.kind
    params = args[0].params if kind == "train" else args[0]
    coll = plan_collectives(
        plan, kind, shape.global_batch, shape.seq_len, knobs["dtype"],
        params, plan.param_specs(), remat=knobs["remat"],
        S_cache=shape.seq_len, S_enc=1500 if cfg.is_encdec else 0)
    # temporaries spread over the devices that split the activations: the
    # batch's dp, and model under SP; the MoE dispatch, which under EP
    # each device runs for every token of its routing groups, over dp only
    dp = meshmod.dp_size(plan.mesh)
    by_dp = dp if shape.global_batch % dp == 0 else 1
    split = by_dp
    if plan.sp and kind != "decode":
        split *= plan.mesh.shape["model"]
    temp = tr.peak(exclude=tr.allocation_ids(leaves(out)), split=split,
                   region_split={"moe_dispatch": by_dp} if plan.ep else None)
    return {
        "flops": tr.flops / chips,
        "bytes": tr.bytes / chips,
        "kernel_flops": tr.kernel_flops / chips,
        "coll_payload": coll.payload_bytes,
        "coll_raw": coll.raw_bytes,
        "coll_ops": dict(coll.op_bytes),
        "coll_counts": dict(coll.op_counts),
        "temp": temp,
        "kernels": {k: dict(v) for k, v in tr.kernels.items()},
    }


def _io_bytes(cfg: ModelConfig, shape: ShapeSpec, plan: Plan,
              knobs) -> Dict[str, float]:
    """The step's inputs, outputs and donated inputs a device holds, from
    their shapes (nothing runs): the state (train) or the caches
    (prefill, decode) come back in place, beside the metrics (fp32
    scalars) or the last logits."""
    try:
        _, args, in_sh, _, donate = build_step(cfg, shape, plan, knobs)
    finally:
        moe.set_groups(1)
    argument = sum(device_bytes(plan, a, s) for a, s in zip(args, in_sh))
    alias = device_bytes(plan, args[donate[0]], in_sh[donate[0]])
    if shape.kind == "train":
        new = 4 * (6 if cfg.mtp else 5)   # loss, xent, aux, grad_norm, lr
    else:
        logits = torch.empty((shape.global_batch, cfg.vocab),
                             dtype=knobs["dtype"], device=_META)
        new = device_bytes(plan, logits, _logits_spec(plan, logits))
    return {"argument_size_in_bytes": argument,
            "output_size_in_bytes": alias + new,
            "alias_size_in_bytes": alias}


def _logits_spec(plan: Plan, logits) -> Tuple:
    """The last-token logits (B, V): batch on dp when it divides, the
    vocabulary on ``model`` when its rule says so."""
    b = plan.batch_specs({"x": logits})["x"][0]
    return (b, plan.rules.get("vocab"))


# --------------------------------------------------------------------------- #
# depth extrapolation                                                          #
#                                                                              #
# Per-layer costs are affine in the layer count, so 1 and 2 periods of the    #
# layer pattern (prefix layers kept; and 1, 2 encoder layers) give the full   #
# depth's: F(k) = c0 + c1*k (+ c2*enc_layers).  The port has no scan, so the  #
# result equals a full-depth trace's; the reference needs the extrapolation  #
# because XLA's cost analysis counts a loop body once.  So do the            #
# temporaries: a train step's peak (remat keeps each layer's input) is affine #
# too, and an inference step's, whose activations do not outlive a layer, is #
# the largest of the points'.                                                 #
# --------------------------------------------------------------------------- #
def _measure_point(cfg: ModelConfig, shape: ShapeSpec, plan: Plan,
                   knobs) -> Dict:
    """Trace one shallow variant; return per-device costs.  Everything
    (state, caches, plan) is built for the *shallow* config — the
    optimizer's and the parameters' costs are affine in depth too."""
    plan = make_plan(cfg, plan.mesh, fsdp=plan.fsdp, ep=plan.ep, sp=plan.sp,
                     ep2=plan.ep2)
    return _trace(cfg, shape, plan, knobs)


def _combine(points: List[Dict], weights: List[float]) -> Dict:
    """Linear combination of measurement dicts."""
    out: Dict[str, Any] = {}
    for key in ("flops", "bytes", "coll_payload", "coll_raw",
                "kernel_flops"):
        out[key] = max(0.0, sum(w * p[key] for p, w in zip(points, weights)))
    for field in ("coll_ops", "coll_counts"):
        acc: Dict[str, float] = {}
        for p, w in zip(points, weights):
            for k, v in p[field].items():
                acc[k] = acc.get(k, 0.0) + w * v
        out[field] = {k: max(0.0, v) for k, v in acc.items()}
    kernels: Dict[str, Dict[str, float]] = {}
    for p, w in zip(points, weights):
        for name, c in p["kernels"].items():
            got = kernels.setdefault(name, {})
            for k, v in c.items():
                got[k] = got.get(k, 0.0) + w * v
    out["kernels"] = kernels
    return out


def extrapolate_costs(cfg: ModelConfig, shape: ShapeSpec, plan: Plan,
                      knobs) -> Dict:
    """Per-device costs and temporaries of the full-depth model from
    shallow traces.  A depth that is not a whole number of periods
    (RecurrentGemma-2B's 26 layers of a 3-layer pattern) takes one more
    trace for the rest, so the counts stay exact, where the reference
    weighs the rest as a fraction of a period."""
    p = len(cfg.attn_pattern) or 1
    prefix = cfg.first_dense
    k_full = (cfg.n_layers - prefix) / p
    k_int, rest = divmod(cfg.n_layers - prefix, p)

    def mk(nl, ne):
        return dataclasses.replace(cfg, n_layers=nl, encoder_layers=ne)
    knobs = dict(knobs, microbatches=1)

    ne0 = 1 if cfg.encoder_layers else 0
    depths = [(prefix + p, ne0), (prefix + 2 * p, ne0)]
    # F = f1 + (k - 1)(f2 - f1) [+ (ne - 1)(f3 - f1)] [+ (f_rest - f1)]
    weights = [1.0 - (k_int - 1.0), k_int - 1.0]
    if cfg.encoder_layers:
        depths.append((prefix + p, 2))
        weights.append(cfg.encoder_layers - 1.0)
        weights[0] -= cfg.encoder_layers - 1.0
    if rest:
        depths.append((prefix + p + rest, ne0))
        weights.append(1.0)
        weights[0] -= 1.0
    points = [_measure_point(mk(nl, ne), shape, plan, knobs)
              for nl, ne in depths]
    est = _combine(points, weights)
    if shape.kind == "train":
        est["temp"] = max(0.0, sum(w * q["temp"]
                                   for q, w in zip(points, weights)))
    else:       # the points no deeper than the model
        est["temp"] = max(q["temp"] for q, (nl, ne) in zip(points, depths)
                          if nl <= cfg.n_layers and ne <= cfg.encoder_layers)
    est["k_full"] = k_full
    est["period"] = p
    return est


# --------------------------------------------------------------------------- #
# one cell                                                                     #
# --------------------------------------------------------------------------- #
def trace_cell(cfg: ModelConfig, shape, mesh: Mesh, knobs=None,
               hw: Optional[roofline.HW] = None, extrap: bool = True
               ) -> Dict[str, Any]:
    """The record's measured part for ``cfg`` at ``shape`` (a ``SHAPES``
    name or any ``ShapeSpec``) on ``mesh``: the plan, the costs and the
    temporaries from shallow traces (``extrap``) or one full-depth trace,
    the inputs' and outputs' bytes from their shapes, the roofline terms
    under ``hw`` (H100 defaults).  ``knobs`` update the ``("*", "*")``
    preset."""
    shape = _shape(shape)
    knobs = dict(preset("*", "*"), **(knobs or {}))
    if knobs.get("ep_pad"):
        cfg = dataclasses.replace(cfg, n_experts_pad=int(knobs["ep_pad"]))
    chips = mesh.size
    plan = make_plan(cfg, mesh, fsdp=knobs["fsdp"], ep=knobs["ep"],
                     sp=knobs["sp"], ep2=knobs["ep2"])
    t0 = time.perf_counter()
    est = (extrapolate_costs(cfg, shape, plan, knobs) if extrap
           else _trace(cfg, shape, plan, knobs))
    t_trace = time.perf_counter() - t0
    memory = _mem_dict(dict(_io_bytes(cfg, shape, plan, knobs),
                            temp_size_in_bytes=round(est["temp"])))

    hw = hw or roofline.HW(chips=chips)
    flops_global = est["flops"] * chips
    bytes_global = est["bytes"] * chips
    est_coll = roofline.CollectiveStats(
        op_bytes=est["coll_ops"], payload_bytes=est["coll_payload"],
        raw_bytes=est["coll_raw"])
    terms = roofline.roofline_terms(flops_global, bytes_global, est_coll, hw)
    mflops = model_flops(cfg, shape)
    return {
        "plan": {"fsdp": plan.fsdp, "ep": plan.ep, "sp": plan.sp,
                 "ep2": plan.ep2,
                 "rules": {k: v for k, v in plan.rules.items() if v}},
        "status": "ok",
        "chips": chips,
        "extrapolated": extrap,
        "trace_s": round(t_trace, 2),
        "flops": flops_global,
        "bytes_accessed": bytes_global,
        "kernel_flops": est["kernel_flops"] * chips,
        "kernels": est["kernels"],
        "memory_analysis": memory,
        "collectives": {
            "per_op_bytes": est["coll_ops"],
            "per_op_counts": est["coll_counts"],
            "raw_bytes": est["coll_raw"],
            "payload_bytes_per_chip": est["coll_payload"],
        },
        "roofline": terms,
        "hw": {"device": "NVIDIA H100 SXM (data sheet)",
               "peak_flops": hw.peak_flops, "hbm_bw": hw.hbm_bw,
               "link_bw": hw.ici_bw},
        "model_flops": mflops,
        "model_vs_hlo_flops": mflops / flops_global if flops_global else 0.0,
        "knobs": {k: str(v) for k, v in knobs.items()},
    }


def run_cell(arch: str, shape_name: str, multi_pod: bool,
             out_dir: Optional[str] = DEFAULT_OUT, verbose: bool = True,
             extrap: bool = True) -> Dict:
    """One cell's record, written to ``out_dir``: extrapolated from shallow
    traces on the single pod (unless ``extrap`` is off), one full-depth
    trace on the two pods."""
    extrap = extrap and not multi_pod
    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    mesh_name = "multi" if multi_pod else "single"
    record: Dict[str, Any] = {
        "arch": arch, "shape": shape_name, "mesh": mesh_name,
        "kind": shape.kind, "seq_len": shape.seq_len,
        "global_batch": shape.global_batch,
    }
    ok, why = shape_applicable(cfg, shape)
    if not ok:
        record["status"] = "skipped"
        record["reason"] = why
        _dump(record, out_dir)
        if verbose:
            print(f"[dryrun] {arch} x {shape_name} x {mesh_name}: SKIP ({why})")
        return record
    record.update(trace_cell(cfg, shape,
                             meshmod.make_production_mesh(multi_pod=multi_pod),
                             knobs=preset(arch, shape_name), extrap=extrap))
    if verbose:
        terms = record["roofline"]
        print(f"[dryrun] {arch} x {shape_name} x {mesh_name}: OK "
              f"(trace {record['trace_s']:.1f}s"
              f"{', extrapolated' if extrap else ''})")
        print(f"  memory_analysis: {record['memory_analysis']}")
        print(f"  cost (global): flops={record['flops']:.3e} "
              f"bytes={record['bytes_accessed']:.3e} "
              f"model/trace={record['model_vs_hlo_flops']:.3f}")
        print(f"  collectives: {record['collectives']['per_op_counts']} "
              f"payload/chip="
              f"{record['collectives']['payload_bytes_per_chip']:.3e}B")
        print(f"  roofline: "
              f"{ {k: (f'{v:.4g}' if isinstance(v, float) else v) for k, v in terms.items()} }")
    _dump(record, out_dir)
    return record


def model_flops(cfg: ModelConfig, shape: ShapeSpec) -> float:
    """MODEL_FLOPS: 6*N*D for training (N = active params), 2*N*D for a
    forward-only step (prefill/decode)."""
    n_active = cfg.active_param_count()
    if shape.kind == "train":
        return 6.0 * n_active * shape.global_batch * shape.seq_len
    if shape.kind == "prefill":
        return 2.0 * n_active * shape.global_batch * shape.seq_len
    return 2.0 * n_active * shape.global_batch            # one token a request


def _mem_dict(mem) -> Dict[str, float]:
    """A memory analysis as the record keeps it: the per-device bytes of
    the arguments, outputs, temporaries and aliased (donated) buffers,
    floats under XLA's names."""
    keys = ("argument_size_in_bytes", "output_size_in_bytes",
            "temp_size_in_bytes", "alias_size_in_bytes")
    return {k: float(mem[k]) for k in keys if k in mem}


def _dump(record: Dict, out_dir: Optional[str]) -> None:
    if out_dir is None:
        return
    os.makedirs(out_dir, exist_ok=True)
    name = f"{record['arch']}__{record['shape']}__{record['mesh']}.json"
    with open(os.path.join(out_dir, name), "w") as f:
        json.dump(record, f, indent=1)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None, choices=list(SHAPES))
    ap.add_argument("--mesh", default="single",
                    choices=["single", "multi", "both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default=DEFAULT_OUT)
    ap.add_argument("--skip-existing", action="store_true")
    ap.add_argument("--no-extrap", action="store_true",
                    help="full-depth trace only (no shallow extrapolation)")
    ap.add_argument("--set", action="append", default=[],
                    help="knob override k=v (microbatches=8, ep2=1, sp=0...)"
                         " applied to every cell in this invocation")
    args = ap.parse_args(argv)
    for kv in args.set:
        k, v = kv.split("=", 1)
        cast = {"microbatches": int, "ep_pad": int}.get(
            k, lambda x: bool(int(x)))
        PRESETS.setdefault(("*", "*"), {})[k] = cast(v)

    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]
    if args.all:
        cells = [(a, s) for a in ARCHS for s in SHAPES]
    else:
        if args.arch is None or args.shape is None:
            ap.error("give --arch and --shape, or --all")
        cells = [(ALIASES.get(args.arch, args.arch.replace("-", "_")),
                  args.shape)]
    failures = 0
    for arch, shape in cells:
        for mp in meshes:
            mesh_name = "multi" if mp else "single"
            path = os.path.join(args.out, f"{arch}__{shape}__{mesh_name}.json")
            if args.skip_existing and os.path.exists(path):
                try:
                    with open(path) as f:
                        cached = json.load(f).get("status")
                except (OSError, ValueError):
                    cached = None
                if cached in ("ok", "skipped"):
                    print(f"[dryrun] {arch} x {shape} x {mesh_name}: cached")
                    continue
            try:
                run_cell(arch, shape, mp, out_dir=args.out,
                         extrap=not args.no_extrap)
            except Exception as e:  # noqa: BLE001 — report, go on
                failures += 1
                print(f"[dryrun] {arch} x {shape} x {mesh_name}: FAIL {e!r}")
    return 1 if failures else 0


if __name__ == "__main__":
    raise SystemExit(main())
