"""The kernel launches of a train step, counted on the CPU, against the
count ``chip_smoke.py``'s phase 9 (a) expects on the card
(``train_launches``), all on the route it expects (``TRAIN_KERNELS``:
fp32 attention on ``tf32x3``), for every arch that phase trains, at its
reduced config, with remat on and 1 or 2 microbatches; and each check's
config cut from the published one in depth alone.

``kernels.ops`` is set as on the card: every entry takes the path that
launches and counts (``_on_cuda`` true), and each launch runs the kernel's
plain version (the recurrences' chunked algorithms, the routes the card
takes at these lengths).  The MoE calls' order in a step is held to
``train_routing_where``, which places each recorded routing at its layer.
"""
import dataclasses
import pathlib
import runpy

import pytest
import torch

from repro_torch import configs
from repro_torch.kernels import ops
from repro_torch.kernels.flash_attention import flash_attention_plain
from repro_torch.kernels.rglru_scan import linear_recurrence_chunked_plain
from repro_torch.kernels.rwkv6_scan import wkv6_chunked_plain
from repro_torch.models import moe
from repro_torch.models.config import MOE, layer_plan
from repro_torch.train import trainer
from repro_torch.train.data import data_for
from repro_torch.train.optimizer import OptConfig

ROOT = pathlib.Path(__file__).resolve().parents[1]
SMOKE = runpy.run_path(str(ROOT / "chip_smoke.py"),
                       run_name="chip_smoke_train_launches")
CHECKS = SMOKE["TRAIN_CHECKS"]
ARCHS = sorted({case[0] for case in CHECKS})
# at or above both recurrences' chunked-route thresholds, as on the card
T = 128


@pytest.fixture
def launching(monkeypatch):
    """``kernels.ops`` taking its launching path on CPU tensors, each
    launch its kernel's plain version; the counters zeroed."""
    monkeypatch.setattr(ops, "_on_cuda", lambda t: True)
    monkeypatch.setattr(ops, "flash_attention_cuda",
                        lambda q, k, v, **kw: flash_attention_plain(
                            q, k, v, **kw))
    monkeypatch.setattr(ops, "rglru_scan_cuda", linear_recurrence_chunked_plain)
    monkeypatch.setattr(ops, "wkv6_cuda",
                        lambda *a, state_out=None, route=None:
                        wkv6_chunked_plain(*a, state_out=state_out))
    ops.reset_launches()
    yield
    ops.reset_launches()


def _one_step(cfg, microbatches):
    state = trainer.init_train_state(cfg, torch.Generator().manual_seed(0),
                                     device="cpu")
    step = trainer.make_train_step(
        cfg, OptConfig(lr=1e-3, warmup_steps=0, total_steps=10),
        microbatches=microbatches)
    batch = data_for(cfg, 2, T, seed=0, n_enc=64,
                     device="cpu").batch_for_step(0)
    _, metrics = step(state, batch)
    assert torch.isfinite(metrics["loss"])


@pytest.mark.parametrize("microbatches", [1, 2])
@pytest.mark.parametrize("arch", ARCHS)
def test_a_train_step_launches_what_chip_smoke_expects(arch, microbatches,
                                                       launching):
    cfg = configs.get_reduced(arch)
    _one_step(cfg, microbatches)
    for kernel, route in SMOKE["TRAIN_KERNELS"][arch].items():
        n = microbatches * SMOKE["train_launches"](cfg, kernel)
        assert n > 0
        assert ops.launches[kernel] == n, kernel
        assert SMOKE["route_counts"](ops.routes[kernel]) == {route: n}, kernel


@pytest.mark.parametrize("microbatches", [1, 2])
@pytest.mark.parametrize("arch", ["qwen2-moe-a2.7b", "deepseek-v3-671b"])
def test_moe_calls_sit_where_chip_smoke_places_them(arch, microbatches,
                                                    launching, monkeypatch):
    """A step's MoE calls (forward, then the remat recompute in the
    backward's order), identified by their router leaf, against
    ``train_routing_where``."""
    cfg = dataclasses.replace(configs.get_reduced(arch), n_layers=3)
    n_moe = sum(b.mlp == MOE for b in layer_plan(cfg))
    assert n_moe >= 2
    calls, apply = [], moe.moe_apply

    def recorded(cfg_, p, x):
        calls.append(p["router"].data_ptr())
        return apply(cfg_, p, x)
    monkeypatch.setattr(moe, "moe_apply", recorded)
    _one_step(cfg, microbatches)
    layer_of = {}
    for ptr in calls:
        layer_of.setdefault(ptr, len(layer_of))
    where = SMOKE["train_routing_where"](n_moe, microbatches)
    assert len(calls) == 2 * n_moe * microbatches
    assert [layer_of[p] for p in calls] == [where(i)[1]
                                            for i in range(len(calls))]
    assert {where(i)[0] for i in range(len(calls))} == {0}


@pytest.mark.parametrize("case", CHECKS,
                         ids=[f"{c[0]}-{i}" for i, c in enumerate(CHECKS)])
def test_a_check_cuts_its_config_in_depth_alone(case):
    cfg = SMOKE["train_config"](case)
    published = configs.get_config(case[0])
    changed = {f.name for f in dataclasses.fields(cfg)
               if getattr(cfg, f.name) != getattr(published, f.name)}
    assert changed <= {"n_layers", "encoder_layers"}
    assert cfg.n_layers == case[1] < published.n_layers
    assert cfg.encoder_layers == (case[1] if published.is_encdec else 0)
    assert case[0] in SMOKE["TRAIN_KERNELS"]
