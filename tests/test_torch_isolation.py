"""The port stands alone: it imports neither jax nor the JAX package (nor
do ``chip_smoke.py``, ``ab_alloc.py``, ``ab_prefill.py`` and
``ab_serve.py``; the launch
tools, the dry run among them, included), and its
device entry points (the sweeps, ``api.sweep``, the tuner's races, the
session server, the CLI and the legacy wrappers included) run on the card
unless told otherwise."""
import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch import api
from repro_torch.core.alloc_torch import (TorchAllocBackend,
                                          TorchBatchedAllocator,
                                          resolve_device)
from repro_torch.configs import get_reduced
from repro_torch.launch.serve import main as serve_main
from repro_torch.models import backbone, blocks, moe
from repro_torch.models.layers import mlp_init, uinit
from repro_torch.sched.sweep import grid, run_batched
from repro_torch.train.serve import BatchedServer, ServeConfig
from repro_torch.tune import Variant

ROOT = pathlib.Path(__file__).resolve().parents[1]

_PROBE = r"""
import importlib, json, pkgutil, sys
import repro_torch
mods = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                               "repro_torch.")]
for m in mods:
    importlib.import_module(m)
from repro_torch.kernels.rglru_scan import (  # noqa: F401
    linear_recurrence_chunked_plain, rglru_route)
from repro_torch.kernels.rwkv6_scan import (  # noqa: F401
    wkv6_chunked_plain, wkv6_route)
import runpy
for path in sys.argv[1:]:
    runpy.run_path(path, run_name="chip_smoke_probe")
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith(("jax.", "jaxlib"))
             or m == "repro" or m.startswith("repro."))
print(json.dumps({"modules": mods, "bad": bad}))
"""


def test_port_and_chip_smoke_import_no_jax_or_reference():
    src = ROOT / "src"
    proc = subprocess.run(
        [sys.executable, "-c", _PROBE, str(ROOT / "chip_smoke.py"),
         str(ROOT / "ab_alloc.py"), str(ROOT / "ab_prefill.py"),
         str(ROOT / "ab_serve.py")],
        capture_output=True, text=True, timeout=120,
        env={**os.environ, "PYTHONPATH": str(src)})
    assert proc.returncode == 0, proc.stderr
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert "repro_torch.core.alloc_torch" in out["modules"]
    assert "repro_torch.kernels.ops" in out["modules"]
    for mod in ("device", "models.config", "models.layers", "models.blocks",
                "models.backbone", "models.convert", "configs",
                "configs.recurrentgemma_2b", "configs.rwkv6_7b",
                "kernels.flash_attention", "kernels.rglru_scan",
                "kernels.maxmin_solve", "kernels.alloc_matvec",
                "kernels.rwkv6_scan", "train.serve", "launch.serve",
                "core.mcb8", "core.stretch_opt", "workloads.hpc2n",
                "workloads.registry", "sched.components", "sched.session",
                "sched.sweep", "core.ioutil", "api", "workloads.jobgen",
                "sched.scenarios", "sched.narrator", "sched.cluster",
                "tune", "tune.score", "tune.race", "tune.controller",
                "serve", "serve.protocol", "serve.admission",
                "serve.registry", "serve.server", "serve.client",
                "__main__", "sched._compat", "sched.simulator",
                "sched.batch", "core.equipartition", "core.alloc_reference",
                "kernels.node_usage", "kernels.ref", "train.tree",
                "train.optimizer", "train.compression", "train.data",
                "train.checkpoint", "train.trainer", "train.ft",
                "launch.train", "models.moe", "configs.qwen2_moe_a2_7b",
                "configs.deepseek_v3_671b", "launch.mesh",
                "launch.shardings", "launch.roofline", "launch.cost",
                "launch.dryrun", "kernels.meta_cost"):
        assert f"repro_torch.{mod}" in out["modules"]
    assert out["bad"] == []


def test_the_client_imports_no_torch():
    """``repro_torch.serve.client`` (and the ``client`` subcommand) is a
    plain socket program."""
    probe = ("import sys; from repro_torch.serve.client import Client; "
             "import repro_torch.__main__; "
             "print(any(m == 'torch' or m.startswith('torch.') "
             "for m in sys.modules))")
    proc = subprocess.run([sys.executable, "-c", probe], capture_output=True,
                          text=True, timeout=120,
                          env={**os.environ, "PYTHONPATH": str(ROOT / "src")})
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "False"


def _need_no_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works")


def test_allocators_default_to_cuda_and_raise_without_it():
    _need_no_cuda()
    for cls in (TorchBatchedAllocator, TorchAllocBackend):
        with pytest.raises(RuntimeError, match="CUDA"):
            cls()
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device("cuda")


def test_entry_points_default_to_cuda_and_raise_without_it():
    _need_no_cuda()
    w = api.WorkloadSpec("lublin", n_jobs=10, n_nodes=4, seed=0)
    with pytest.raises(RuntimeError, match="CUDA"):
        api.simulate(w, "GreedyP */OPT=MIN")
    with pytest.raises(RuntimeError, match="CUDA"):
        run_batched(grid([w], ["GreedyP */OPT=MIN"]))


def test_session_entry_points_default_to_cuda_and_raise_without_it():
    _need_no_cuda()
    with pytest.raises(RuntimeError, match="CUDA"):
        api.open_session(4, "GreedyP */OPT=MIN")
    with pytest.raises(RuntimeError, match="CUDA"):
        api.SimSession("GreedyP */OPT=MIN", api.SimParams(n_nodes=4))
    ses = api.open_session(4, "GreedyP */OPT=MIN", device="cpu")
    ses.submit(api.WorkloadSpec("lublin", n_jobs=10, n_nodes=4, seed=0))
    ses.step(5)
    snap = ses.snapshot()
    with pytest.raises(RuntimeError, match="CUDA"):
        api.SimSession.restore(snap)
    with pytest.raises(RuntimeError, match="CUDA"):
        ses.fork()
    with pytest.raises(RuntimeError, match="CUDA"):
        api.run_branches(snap, ["GreedyP */OPT=MIN"])
    # on the CPU when asked, and with the torch backend attached
    assert api.SimSession.restore(snap, device="cpu").engine.alloc_backend
    rec = api.run_branches(snap, ["EASY"], device="cpu").records[0]
    assert rec["backend"] == "torch" and rec["max_stretch"] >= 1.0


def test_grid_and_tuner_entry_points_default_to_cuda_and_raise_without_it(
        tmp_path):
    _need_no_cuda()
    w = api.WorkloadSpec("lublin", n_jobs=10, n_nodes=4, seed=0)
    cells = api.grid([w], ["GreedyP */OPT=MIN"], ["rack_failure"])
    with pytest.raises(RuntimeError, match="CUDA"):
        api.run_grid(cells)
    with pytest.raises(RuntimeError, match="CUDA"):
        api.run_grid(cells, retries=1)
    with pytest.raises(RuntimeError, match="CUDA"):
        api.sweep([w], ["GreedyP */OPT=MIN"],
                  cache_path=str(tmp_path / "c.json"))
    ses = api.open_session(4, "GreedyP */OPT=MIN", device="cpu")
    ses.submit(w)
    ses.step(3)
    with pytest.raises(RuntimeError, match="CUDA"):
        api.race(ses.snapshot(), [], Variant("EASY"), base_horizon=100.0)
    # the tuner races where its session allocates: here, the CPU
    tuner = api.autotune(ses, "every=100;policies=EASY")
    assert str(tuner._race_target(ses)["device"]) == "cpu"
    # on the CPU and on the host when asked
    assert api.run_grid(cells, device="cpu").records[0]["backend"] == "torch"
    assert api.sweep([w], ["EASY"], backend="numpy").n_cells == 1


@pytest.mark.parametrize("arch", ["recurrentgemma-2b", "rwkv6-7b",
                                  "qwen2-moe-a2.7b", "deepseek-v3-671b"])
def test_serving_entry_points_default_to_cuda_and_raise_without_it(arch):
    _need_no_cuda()
    cfg = get_reduced(arch)
    gen = torch.Generator().manual_seed(0)
    with pytest.raises(RuntimeError, match="CUDA"):
        backbone.init_params(cfg, gen)
    with pytest.raises(RuntimeError, match="CUDA"):
        backbone.init_cache(cfg, 1, 8)
    params = backbone.init_params(cfg, gen, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        BatchedServer(cfg, params, ServeConfig(slots=1, cache_len=8))
    with pytest.raises(RuntimeError, match="CUDA"):
        serve_main(["--arch", arch, "--reduced"])


def test_block_builders_take_the_device_from_the_caller():
    """The per-layer builders have no default device: only the entry
    points above choose one (the card)."""
    cfg = get_reduced("recurrentgemma-2b")
    gen = torch.Generator().manual_seed(0)
    ds = get_reduced("deepseek-v3-671b")
    for build, c in ((blocks.attn_init, cfg), (blocks.rglru_init, cfg),
                     (blocks.mlp_block_init, cfg), (blocks.rwkv6_init, cfg),
                     (blocks.mla_init, ds), (moe.moe_init, ds)):
        with pytest.raises(TypeError):
            build(c, gen, torch.float32)
        p = build(c, gen, torch.float32, "cpu")
        assert all(t.device.type == "cpu" for t in p.values())
    for build, c in ((blocks.attn_cache, cfg), (blocks.rglru_cache, cfg),
                     (blocks.rwkv6_cache, cfg), (blocks.mla_cache, ds)):
        with pytest.raises(TypeError):
            build(c, 1, 8, torch.float32)
    with pytest.raises(TypeError):
        uinit(gen, (4, 4), None, torch.float32)
    with pytest.raises(TypeError):
        mlp_init(gen, 4, 8, "gelu_gated", torch.float32)


def test_serving_launcher_runs_on_the_cpu_when_asked(capsys):
    assert serve_main(["--arch", "recurrentgemma-2b", "--reduced",
                       "--device", "cpu", "--requests", "3", "--slots", "2",
                       "--cache-len", "32", "--max-new", "3"]) == 0
    assert "[serve] 3/3 requests" in capsys.readouterr().out


def test_cpu_device_is_explicit():
    assert resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(ValueError):
        resolve_device("meta")
    r = api.simulate(api.WorkloadSpec("lublin", n_jobs=10, n_nodes=4, seed=0),
                     "GreedyP */OPT=MIN", device="cpu")
    assert np.isfinite(r.max_stretch) and r.max_stretch >= 1.0


def test_the_server_defaults_to_cuda_and_raises_before_binding():
    _need_no_cuda()
    import asyncio

    from repro_torch.device import BackendFault
    from repro_torch.serve import SchedServer, ServeConfig, ServerThread

    assert ServeConfig().device == "cuda"
    server = SchedServer(ServeConfig())
    with pytest.raises(BackendFault, match="CUDA"):
        asyncio.run(server.start())
    assert server.port is None and server._server is None
    thread = ServerThread(ServeConfig())
    with pytest.raises(RuntimeError, match="failed to start"):
        thread.start()
    assert thread.port is None and isinstance(thread.error, BackendFault)
    announced = []
    with pytest.raises(BackendFault, match="CUDA"):
        api.serve(announce=announced.append)
    assert announced == []


def test_the_cli_defaults_to_cuda_and_exits_non_zero_without_it(tmp_path):
    _need_no_cuda()
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    for argv in (["simulate", "--policy", "GreedyP */OPT=MIN", "--jobs",
                  "10", "--nodes", "4"],
                 ["serve", "--port-file", str(tmp_path / "port")]):
        proc = subprocess.run([sys.executable, "-m", "repro_torch", *argv],
                              capture_output=True, text=True, timeout=120,
                              env=env)
        assert proc.returncode != 0 and "CUDA" in proc.stderr
        assert not proc.stdout.strip()
    assert not (tmp_path / "port").exists()     # the server never listened


def test_legacy_wrappers_default_to_cuda_and_raise_without_it():
    _need_no_cuda()
    import warnings

    from repro_torch.sched import DFRSSimulator, batch_schedule, simulate
    from repro_torch.sched.engine import SimParams
    from repro_torch.workloads.registry import WorkloadSpec, make_trace

    specs = make_trace(WorkloadSpec("lublin", n_jobs=10, n_nodes=4, seed=0))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        for policy in ("GreedyP */OPT=MIN", "FCFS"):
            with pytest.raises(RuntimeError, match="CUDA"):
                simulate(specs, policy, SimParams(n_nodes=4))
        with pytest.raises(RuntimeError, match="CUDA"):
            DFRSSimulator(specs, "GreedyP */OPT=MIN", SimParams(n_nodes=4))
        for algo in ("FCFS", "EASY"):
            with pytest.raises(RuntimeError, match="CUDA"):
                batch_schedule(specs, algo, SimParams(n_nodes=4))
        assert batch_schedule(specs, "EASY", SimParams(n_nodes=4),
                              device="cpu").max_stretch >= 1.0
