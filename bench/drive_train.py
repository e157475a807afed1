"""The runner of a training cell: set-up, the checked steps, the timed
window, the trace, and the comparison with the plain reference.

Set-up builds one training state from the seed (the configuration's
parameters in the port's training layout, drawn by ``weights``; zero
optimizer state) and one step (``repro_torch.train.trainer
.make_train_step``, the step ``launch.train`` runs), and drives it
through the traffic's ``checked_steps`` first batches; those steps
compile and warm up every shape the window uses.  Their readings (each
loss, each leaf's first clipped gradient as the optimizer's first moment
holds it, each leaf's change over the checked steps) are kept, and the
same state goes on into the window.  The window runs whole steps, each
ending in a synchronise, until ``seconds`` have passed.  Once it has
closed and the program's state is freed, the reference runs the checked
steps from the seed and ``check`` compares.
"""
from __future__ import annotations

import gc
import importlib
import math
import sys
import time
from typing import Dict, Optional

import torch

from . import check, common, devtrace, gen, weights
from .peaks import PEAKS
from .reference import train as ref_train


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _peak(device) -> int:
    return torch.cuda.max_memory_allocated(device) if device.type == "cuda" \
        else 0


def opt_config(spec: Dict, OptConfig):
    """The program's optimizer settings from the traffic's ``optimizer``
    entry; the program decays every leaf of 2 or more dimensions and has
    no option for another rule."""
    if spec["decay_min_dims"] != 2:
        raise ValueError("the program decays leaves of 2 or more "
                         "dimensions only")
    if spec["name"] != "adamw":
        raise ValueError(f"the check reads AdamW's first moment; "
                         f"{spec['name']!r} has no check yet")
    keys = ("lr", "warmup_steps", "total_steps", "min_lr_frac", "b1", "b2",
            "eps", "weight_decay", "clip_norm")
    return OptConfig(**{k: spec[k] for k in keys}, factored=False)


def check_layout(params, cfg, backbone, tree) -> None:
    """The harness's parameter tree must be the program's training layout
    leaf for leaf."""
    mine, s_mine = tree.flatten(params)
    theirs, s_theirs = tree.flatten(backbone.param_shapes(cfg))
    if s_mine != s_theirs or [tuple(p.shape) for p in mine] != [
            tuple(p.shape) for p in theirs]:
        raise RuntimeError("the configuration's parameter layout is not the "
                           "program's training layout")


def prepare(c: Dict, seed: int, device) -> Dict:
    """Set-up: the training state from the seed, the program's step, the
    traffic, and the program's readings of the checked steps, which the
    state has been driven through."""
    from repro_torch.kernels import ops
    from repro_torch.models import backbone
    from repro_torch.models.config import ModelConfig
    from repro_torch.train import trainer, tree
    from repro_torch.train.optimizer import OptConfig, init_opt_state

    device = torch.device(device)
    conf, traffic = c["config"], c["traffic"]
    m = conf["model"]
    if conf["dtype"] != "float32":
        raise ValueError(f"the harness trains in float32, the configuration "
                         f"states {conf['dtype']}")
    torch.backends.cuda.matmul.allow_tf32 = False       # fp32, as stated
    torch.backends.cudnn.allow_tf32 = False
    cfg = ModelConfig(**m)
    layout = importlib.import_module(
        f".reference.{conf['reference']}", __package__).layout(m)
    params = weights.make_params(layout, seed, device)
    check_layout(params, cfg, backbone, tree)
    spec = traffic["optimizer"]
    state = trainer.TrainState(params, init_opt_state(params), None)
    del params
    step = trainer.make_train_step(cfg, opt_config(spec, OptConfig),
                                   microbatches=traffic["microbatches"],
                                   remat=traffic["remat"])
    data = gen.TrainTraffic(traffic, m, device)

    ops.reset_launches()
    prog = {"loss": [], "grad": {}, "change": {}}
    for i in range(traffic["checked_steps"]):
        state, metrics = step(state, data.batch(seed, i))
        prog["loss"].append(float(metrics["loss"]))
        if i == 0:
            prog["grad"] = {k: float(mu.norm()) / (1 - spec["b1"])
                            for k, mu in weights.leaf_items(state.opt.mu)}
    start = dict(weights.leaf_items(weights.make_params(layout, seed,
                                                        device)))
    with torch.no_grad():
        prog["change"] = {k: float((p - start[k]).norm())
                          for k, p in weights.leaf_items(state.params)}
    return {"state": state, "step": step, "data": data, "readings": prog,
            "routes": {k: dict(v) for k, v in ops.routes.items() if v}}


def run(c: Dict, seed: int, seconds: float, trace: bool, device="cuda",
        t_start: Optional[float] = None,
        chrome_trace: Optional[str] = None) -> Dict:
    """One run of the cell ``c`` (``common.cell``): the result line's
    object, with ``info`` (set-up facts printed on an earlier line)."""
    t_start = time.perf_counter() if t_start is None else t_start
    device = torch.device(device)
    conf, traffic = c["config"], c["traffic"]
    m = conf["model"]
    n_checked = traffic["checked_steps"]
    run_ = prepare(c, seed, device)
    state, step, data = run_["state"], run_["step"], run_["data"]
    prog, routes = run_["readings"], run_["routes"]
    del run_
    _sync(device)
    setup_peak = _peak(device)
    setup_s = time.perf_counter() - t_start

    # ---- the window --------------------------------------------------- #
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    prof = None
    if trace:
        prof = torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA])
        prof.start()
    losses, ends = [], []
    t0 = time.perf_counter()
    while True:
        state, metrics = step(state, data.batch(seed, n_checked + len(losses)))
        _sync(device)
        ends.append(time.perf_counter() - t0)
        losses.append(float(metrics["loss"]))
        if ends[-1] >= seconds:
            break
    window_s = ends[-1]
    window_peak = _peak(device)
    steps = len(losses)

    rec = None
    if trace:
        clock = _Clock()
        prof.stop()
        clock("profiler stopped")
        if chrome_trace:
            prof.export_chrome_trace(chrome_trace)
        dev = devtrace.device_summary(prof)
        clock(f"{dev['events']} device events read")
        del prof
        work = importlib.import_module(f".work.{conf['work']}", __package__)
        rec = {"steps": steps, "window_s": window_s, "device": dev,
               "train_flops": work.train_flops(m, traffic),
               "attention_calls": work.attention_calls(m, traffic),
               "peaks": PEAKS.get(torch.cuda.get_device_name(device), {})}
        if any(metric["name"].split(".")[0] == "host_ops_per_step"
               for metric in common.benchmark()["per_layer"]
               if _lists(metric, c)):
            nxt = data.batch(seed, n_checked + steps)
            rec["host_ops_per_step"] = devtrace.host_ops(
                torch, lambda: step(state, nxt))
            clock("one step traced on the host")
    del state, metrics, step
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()

    # ---- the comparison, once the program's state is gone ------------- #
    ref = ref_train.readings(conf, traffic, seed, device)
    verdict = check.judge(check.gaps(prog, ref), c["limits"])

    failed = sum(not math.isfinite(x) for x in losses)
    result = {"correct": verdict["correct"] and failed == 0,
              "attempted": steps, "failed": failed}
    if trace:
        result["metrics"] = per_layer(c, rec)
    else:
        result["metrics"] = end_to_end(c, {
            "setup_s": setup_s,
            "train_tokens_s": steps * data.positions() / window_s,
            "peak_mem_gib": window_peak / 2**30})
    result["device"] = {
        "platform": "gpu" if device.type == "cuda" else device.type,
        "kind": (torch.cuda.get_device_name(device)
                 if device.type == "cuda" else "cpu"),
        "count": c["workload"]["chips"],
        "memory_peak_bytes": max(setup_peak, window_peak)}
    if trace:
        result["device"].update(busy_s=rec["device"]["busy_s"],
                                 window_s=window_s)
        result["breakdown"] = {
            "device_ops": _top(rec["device"]["by_name"]),
            "idle_gaps": _top(rec["device"]["idle_gaps"])}
    result["checks"] = verdict["checks"]
    result["info"] = {"setup_s": setup_s, "window_s": window_s,
                      "steps": steps, "routes": routes,
                      "step_s": [b - a for a, b in zip([0.0] + ends, ends)],
                      "losses": prog["loss"] + losses}
    return result


class _Clock:
    """Seconds since the last mark, to standard error: where a traced
    run's time goes."""

    def __init__(self):
        self.t = time.perf_counter()

    def __call__(self, what: str) -> None:
        now = time.perf_counter()
        print(f"bench: {what} in {now - self.t:.1f} s", file=sys.stderr)
        self.t = now


def _lists(metric: Dict, c: Dict) -> bool:
    cells = metric.get("workloads")
    return cells is None or c["workload"]["name"] in cells


def end_to_end(c: Dict, values: Dict[str, float]) -> Dict:
    """The end-to-end metrics of ``BENCHMARK.json`` that list this cell
    (or list none).  A metric's value is that of its base name, the part
    before the first dot: ``train_tokens_s.encdec`` is the rate of
    ``train_tokens_s`` under a bound of its own, for the cells it lists."""
    return {m["name"]: {"value": values[m["name"].split(".")[0]],
                        "unit": m["unit"]}
            for m in common.benchmark()["end_to_end"] if _lists(m, c)}


def per_layer(c: Dict, rec: Dict) -> Dict:
    """Every per-layer metric of ``BENCHMARK.json`` that lists this cell
    (or lists none), read by its own reader; a reader that finds nothing
    leaves its metric out."""
    out = {}
    for metric in common.benchmark()["per_layer"]:
        if not _lists(metric, c):
            continue
        reader = common.load_module(common.BENCH / "metrics"
                                    / f"{metric['name']}.py")
        value = reader.read(rec)
        if value is not None:
            out[metric["name"]] = {"value": value, "unit": metric["unit"]}
    return out


def _top(by_name: Dict[str, float], n: int = 10):
    return [[k[:120], v] for k, v in
            sorted(by_name.items(), key=lambda kv: -kv[1])[:n]]
