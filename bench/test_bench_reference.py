"""The plain reference against the port's CPU path, and the harness's
parameter layout against the port's training layout."""
import subprocess
import sys

import pytest
import torch

from bench import check, common, drive_train, weights
from bench.reference import train as ref_train
from bench.reference import transformer
from bench.tiny import TINY, tiny_cell

CELLS = sorted(TINY)


@pytest.mark.parametrize("name", CELLS)
@pytest.mark.parametrize("size", ["full", "tiny"])
def test_layout_is_the_programs(name, size):
    from repro_torch.models import backbone
    from repro_torch.models.config import ModelConfig
    from repro_torch.train import tree

    c = common.cell(name) if size == "full" else tiny_cell(name)
    m = c["config"]["model"]
    meta = weights.nest([(p, torch.empty(s, device="meta"))
                         for p, s, _ in transformer.layout(m)])
    drive_train.check_layout(meta, ModelConfig(**m), backbone, tree)


@pytest.mark.parametrize("name", CELLS)
def test_parameter_count_is_the_files(name):
    c = common.cell(name)
    count = sum(t.numel() for _, t in weights.leaf_items(weights.nest(
        [(p, torch.empty(s, device="meta"))
         for p, s, _ in transformer.layout(c["config"]["model"])])))
    assert count == c["config"]["params"]


@pytest.mark.parametrize("name", CELLS)
@pytest.mark.parametrize("seed", [0, 2**31 + 5])
def test_reference_follows_the_program_on_cpu(name, seed):
    c = tiny_cell(name)
    prog = drive_train.prepare(c, seed, "cpu")["readings"]
    ref = ref_train.readings(c["config"], c["traffic"], seed, "cpu")
    gaps = check.gaps(prog, ref)
    assert all(v < 1e-5 for v in gaps.values()), gaps
    assert len(prog["loss"]) == c["traffic"]["checked_steps"]


def test_weights_repeat_from_the_seed():
    lay = transformer.layout(tiny_cell(CELLS[0])["config"]["model"])
    a = dict(weights.leaf_items(weights.make_params(lay, 3, "cpu")))
    b = dict(weights.leaf_items(weights.make_params(lay, 3, "cpu")))
    c = dict(weights.leaf_items(weights.make_params(lay, 4, "cpu")))
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["embed"], c["embed"])


def test_round_tf32_keeps_ten_mantissa_bits():
    x = torch.tensor([1.0 + 2**-11, 1.0 + 3 * 2**-11, -1.0 - 2**-10 - 2**-12,
                      3.0], dtype=torch.float32)
    r = ref_train.round_tf32(x)
    assert r.tolist() == [1.0, 1.0 + 2**-9, -1.0 - 2**-10, 3.0]


def test_reference_loads_nothing_of_the_program():
    code = ("import sys; sys.path[:0] = ['.', 'src']\n"
            "import bench.reference.train, bench.reference.transformer, "
            "bench.reference.adamw\n"
            "bad = sorted({m.split('.')[0] for m in sys.modules} & "
            "{'repro_torch', 'repro', 'jax', 'jaxlib'})\n"
            "print(bad); sys.exit(1 if bad else 0)")
    out = subprocess.run([sys.executable, "-c", code], cwd=common.ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
