"""``bench/run.py`` on a machine without a card fails with a clear
message and prints no result, and so does a checkout without the
program or with an unknown cell."""
import json
import shutil
import subprocess
import sys

from bench import common


def _run(cwd, *args):
    return subprocess.run(
        [sys.executable, "bench/run.py", *args], cwd=cwd,
        capture_output=True, text=True, timeout=300)


def _no_result(out):
    for line in out.stdout.splitlines():
        try:
            obj = json.loads(line)
        except ValueError:
            continue
        assert "metrics" not in obj


def test_no_card_no_result():
    out = _run(common.ROOT, "--workload", "smollm-360m.pretrain", "--seed",
               "0", "--seconds", "10", "--trace", "0")
    assert out.returncode != 0
    assert "CUDA" in out.stderr and "no CPU fallback" in out.stderr
    _no_result(out)


def test_unknown_cell_no_result():
    out = _run(common.ROOT, "--workload", "no-such.cell", "--seed", "1",
               "--seconds", "10", "--trace", "1")
    assert out.returncode != 0
    _no_result(out)


def test_benchmark_files_alone_no_result(tmp_path):
    shutil.copy(common.ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(common.BENCH, tmp_path / "bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = _run(tmp_path, "--workload", "whisper-large-v3.finetune",
               "--seed", str(2**31 + 3), "--seconds", "10", "--trace", "0")
    assert out.returncode != 0
    _no_result(out)
