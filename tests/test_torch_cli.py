"""``python -m repro_torch`` against ``python -m repro``, on the CPU.

Each subcommand of the JAX package's CLI runs through both packages' ``main``
on the same arguments (the port's with ``--device cpu`` where it simulates;
the listings and ``trace-smoke`` as ``python -m`` processes, whose
registries no other test has added to) and must print the same: ``policies``, ``workloads`` and ``scenarios`` (text
and ``--json``), the ``trace-smoke`` fingerprints, ``simulate`` (text with
the Theorem-1 bound, and ``--json``), ``sweep`` with a record cache, a
``session`` script, the ``tune`` demo of ``BENCH_tune.json`` (its spec;
one swap at 6,000 s, max stretch 301.598467) and a ``client`` script
against a server.
Wall-clock numbers (``sim_wall_s``, a sweep's seconds, a snapshot's
fingerprint, which covers the loop's clock) are left out of the comparison.
"""
import json
import os
import subprocess
import sys

import pytest

from repro.__main__ import main as ref_main

from repro_torch.__main__ import main as port_main
from repro_torch.serve import ServeConfig, ServerThread

CPU = ["--device", "cpu"]


def _both(capsys, argv, port_extra=CPU):
    assert ref_main(list(argv)) == 0
    ref = capsys.readouterr()
    assert port_main(list(argv) + list(port_extra)) == 0
    got = capsys.readouterr()
    return got, ref


def _both_processes(argv):
    """``python -m repro_torch`` and ``python -m repro`` on ``argv``, each
    in a fresh process: their registries hold only what the packages
    register (tests in this process may have added kinds or policies).
    Returns the two standard outputs, the port's first."""
    env = {**os.environ, "PYTHONPATH": os.pathsep.join(sys.path)}
    outs = [subprocess.run([sys.executable, "-m", pkg, *argv],
                           capture_output=True, text=True, timeout=120,
                           env=env) for pkg in ("repro_torch", "repro")]
    assert [p.returncode for p in outs] == [0, 0], [p.stderr for p in outs]
    return outs[0].stdout, outs[1].stdout


@pytest.mark.parametrize("argv", [["policies"], ["policies", "--json"],
                                  ["policies", "--all"], ["workloads"],
                                  ["workloads", "--json"], ["scenarios"],
                                  ["scenarios", "--json"]])
def test_listings_equal_reference(argv):
    got, ref = _both_processes(argv)
    assert got == ref and got


def test_trace_smoke_fingerprints_equal_reference():
    got, ref = _both_processes(["trace-smoke", "--jobs", "20", "--nodes",
                                "8"])
    fps = json.loads(got)
    assert fps == json.loads(ref) and len(fps) > 20


def test_simulate_text_equals_reference(capsys):
    argv = ["simulate", "--policy", "GreedyPM */per/OPT=MIN/MINVT=600",
            "--workload", "lublin", "--jobs", "60", "--nodes", "16",
            "--loads", "0.9", "--bound", "--scenario",
            "rack_failure+arrival_burst"]
    got, ref = _both(capsys, argv)
    assert got.out == ref.out and "degradation from bound" in got.out


def test_simulate_json_equals_reference(capsys):
    argv = ["simulate", "--policy", "Greedy */OPT=AVG", "--jobs", "50",
            "--nodes", "16", "--seeds", "3", "--json"]
    got, ref = _both(capsys, argv)
    a, b = json.loads(got.out), json.loads(ref.out)
    a.pop("sim_wall_s")
    b.pop("sim_wall_s")
    assert a == b


def test_sweep_with_cache_equals_reference(tmp_path, capsys):
    def run(main, tag, extra):
        out, cache = str(tmp_path / f"{tag}.json"), str(tmp_path / f"{tag}c")
        argv = ["sweep", "--policies", "FCFS,EASY+OPT=MIN,GreedyP */OPT=MIN",
                "--workload", "lublin", "--jobs", "20", "--nodes", "16",
                "--seeds", "0,1", "--scenarios", "baseline,rack_failure",
                "--bound", "--out", out, "--cache", cache] + extra
        texts = []
        for _ in range(2):                      # the second from the cache
            assert main(argv) == 0
            # the first line holds the sweep's wall; the last two, paths
            texts.append(capsys.readouterr().out.splitlines()[1:-2])
        records = json.load(open(out))["records"]
        return texts, records, json.load(open(cache))["n_records"]

    got_texts, got, got_n = run(port_main, "port", CPU)
    ref_texts, ref, ref_n = run(ref_main, "ref", [])
    assert got_texts == ref_texts and got_texts[0] == got_texts[1]
    assert got_n == ref_n == 12
    keys = ("workload", "policy", "scenario", "max_stretch", "mean_stretch",
            "makespan", "events", "bound", "degradation")
    assert ([{k: r[k] for k in keys} for r in got]
            == [{k: r[k] for k in keys} for r in ref])


SESSION_SCRIPT = [
    {"op": "submit", "workload": "lublin", "jobs": 40, "seed": 1},
    {"op": "step_until", "t": 3000},
    {"op": "inject", "kind": "fail", "t": 3500, "nodes": [0, 1]},
    {"op": "inject", "kind": "join", "t": 6000, "nodes": [0, 1]},
    {"op": "step", "n": 5},
    {"op": "period", "period": 900},
    {"op": "snapshot", "path": "SNAP"},
    {"op": "submit", "shift": "now", "specs": [
        {"jid": 100 + j, "release": 60.0 * j, "proc_time": 900.0 + 50.0 * j,
         "n_tasks": 1 + j % 3, "cpu_need": 0.5, "mem_req": 0.2}
        for j in range(6)]},
    {"op": "run"},
    {"op": "result"},
]


def _session_lines(main, tmp_path, tag, extra):
    script = tmp_path / f"{tag}.jsonl"
    snap = str(tmp_path / f"{tag}.snap.json")
    script.write_text("\n".join(
        json.dumps({k: (snap if v == "SNAP" else v) for k, v in ev.items()})
        for ev in SESSION_SCRIPT) + "\n")
    metrics = tmp_path / f"{tag}.metrics.jsonl"
    assert main(["session", "--script", str(script), "--policy",
                 "GreedyPM */per/OPT=MIN/MINVT=600", "--nodes", "16",
                 "--metrics", str(metrics)] + extra) == 0
    lines = [json.loads(line) for line in metrics.read_text().splitlines()]
    for line in lines:
        for k in ("wall_s", "sim_wall_s", "fingerprint", "path"):
            line.pop(k, None)
    return lines


def test_session_script_equals_reference(tmp_path):
    got = _session_lines(port_main, tmp_path, "port", CPU)
    ref = _session_lines(ref_main, tmp_path, "ref", [])
    assert got == ref
    assert [l["kind"] for l in got][-1] == "result"
    assert got[-1]["partial"] is False


def test_tune_demo_equals_reference(capsys):
    # the spec of BENCH_tune.json (benchmarks/tune_bench.py)
    argv = ["tune", "--policy", "GreedyP */OPT=MIN", "--spec",
            "every=1500;horizon=4000;rungs=2;margin=0.01;dwell=0;"
            "policies=GreedyP */OPT=MIN|GreedyPM */per/OPT=MIN/MINVT=600",
            "--workload", "lublin", "--jobs", "150", "--nodes", "32",
            "--seeds", "7", "--loads", "1.1", "--seed", "3",
            "--fail-at", "2050", "--join-at", "7000", "--json"]
    got, ref = _both(capsys, argv)
    a, b = json.loads(got.out), json.loads(ref.out)
    a["result"].pop("sim_wall_s")
    b["result"].pop("sim_wall_s")
    assert a == b
    swaps = [d for d in a["decisions"] if d["swapped"]]
    assert len(swaps) == 1 and swaps[0]["t"] == 6000.0
    assert round(a["result"]["max_stretch"], 6) == 301.598467


def test_client_script_equals_reference(tmp_path):
    script = tmp_path / "script.jsonl"
    script.write_text("\n".join(json.dumps(ev) for ev in [
        {"op": "open", "session": "s0", "policy": "GreedyP */OPT=MIN",
         "nodes": 16},
        {"op": "submit", "session": "s0", "workload": "lublin", "jobs": 20,
         "nodes": 16},
        {"op": "step_until", "session": "s0", "t": 2000.0},
        {"op": "step", "session": "ghost"},
        {"op": "run", "session": "s0"},
        {"op": "result", "session": "s0"},
    ]) + "\n")

    def run(main, tag):
        out = tmp_path / f"{tag}.jsonl"
        with ServerThread(ServeConfig(device="cpu")) as srv:
            assert main(["client", "--port", str(srv.port), "--tenant", "t",
                         "--script", str(script), "--keep-going",
                         "--metrics", str(out)]) == 0
        lines = [json.loads(line) for line in out.read_text().splitlines()]
        for line in lines:
            line.pop("sim_wall_s", None)
            line.pop("wall_s", None)
        return lines

    got, ref = run(port_main, "port"), run(ref_main, "ref")
    assert got == ref
    assert [l["kind"] for l in got] == ["open", "submit", "step_until",
                                        "error", "run", "result"]


def test_the_module_runs_as_python_m(tmp_path):
    got, ref = _both_processes(["policies"])
    assert got == ref
