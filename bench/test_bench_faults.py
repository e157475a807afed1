"""The comparison that decides ``correct``: a sound run passes, and the
control and every fault a training cell can have fail, driven through
the rest of a run on the CPU at a small size, under the cell's committed
limits."""
import pytest

from bench import calibrate, check, drive_train
from bench.reference import train as ref_train
from bench.tiny import TINY, tiny_cell

CELLS = sorted(TINY)


@pytest.mark.parametrize("name", CELLS)
def test_a_sound_run_is_correct(name):
    r = drive_train.run(tiny_cell(name), 11, 0.05, False, device="cpu")
    assert r["correct"], r["checks"]
    assert r["attempted"] >= 1 and r["failed"] == 0
    assert list(r)[-2:] == ["checks", "info"]


@pytest.mark.parametrize("name", CELLS)
@pytest.mark.parametrize("fault", sorted(calibrate.FAULTS))
def test_a_fault_is_not_correct(name, fault, monkeypatch):
    from repro_torch.train import trainer

    monkeypatch.setattr(trainer, "make_train_step",
                        calibrate.FAULTS[fault](trainer.make_train_step))
    r = drive_train.run(tiny_cell(name), 12, 0.05, False, device="cpu")
    assert not r["correct"], r["checks"]


@pytest.mark.parametrize("name", CELLS)
@pytest.mark.parametrize("seed", [21, 22, 23])
def test_the_control_is_not_correct(name, seed):
    c = tiny_cell(name)
    ref = ref_train.readings(c["config"], c["traffic"], seed, "cpu")
    ctl = ref_train.readings(c["config"], c["traffic"], seed, "cpu",
                             tf32=True)
    assert not check.judge(check.gaps(ctl, ref), c["limits"])["correct"]


def test_a_missing_leaf_fails():
    ref = {"loss": [1.0], "grad": {"a": 1.0, "b": 2.0},
           "change": {"a": 1.0, "b": 1.0}}
    prog = {"loss": [1.0], "grad": {"a": 1.0},
            "change": {"a": 1.0, "b": 1.0}}
    gaps = check.gaps(prog, ref)
    assert not check.judge(gaps, {k: 1.0 for k in check.NAMES})["correct"]
