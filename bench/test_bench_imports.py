"""What a run loads: no module whose top-level name is ``jax``,
``jaxlib``, ``flax`` or ``repro`` (``repro_torch`` passes: top-level
names are compared whole), and nothing of ``benchmarks/``."""
import subprocess
import sys

from bench import common

CODE = r"""
import importlib, sys
from pathlib import Path
sys.path[:0] = ['.', 'src']
import bench.run, bench.drive_train, bench.calibrate, bench.devtrace
from bench import common
for sub in ('metrics', 'reference', 'work'):
    for f in sorted(Path('bench', sub).glob('*.py')):
        if f.stem != '__init__':
            if sub == 'metrics':
                common.load_module(f.resolve())
            else:
                importlib.import_module(f'bench.{sub}.{f.stem}')
import repro_torch.train.trainer, repro_torch.kernels.ops
tops = {m.split('.')[0] for m in sys.modules}
print(sorted(tops & {'jax', 'jaxlib', 'flax', 'repro', 'benchmarks'}))
print('repro_torch' in tops)
"""


def test_no_jax_and_no_reference_package_is_loaded():
    out = subprocess.run([sys.executable, "-c", CODE], cwd=common.ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    bad, has_port = out.stdout.split("\n")[:2]
    assert bad == "[]" and has_port == "True"


def test_forbidden_names_are_compared_whole(monkeypatch):
    for name in ("repro_torch", "repro_torch.train", "jaxtyping", "reprox"):
        monkeypatch.setitem(sys.modules, name, sys)
    assert not {"repro_torch", "jaxtyping", "reprox"} & set(
        common.forbidden_loaded())
    monkeypatch.setitem(sys.modules, "repro.sched", sys)
    assert "repro.sched" in common.forbidden_loaded()


def test_nothing_reads_the_reference_benchmarks():
    for f in common.BENCH.rglob("*.py"):
        if f.name.startswith("test_"):
            continue
        text = f.read_text()
        assert "benchmarks." not in text and "benchmarks/" not in text, f
