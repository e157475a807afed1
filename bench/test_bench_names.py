"""``BENCHMARK.json`` and the files it names against the contract's
limits: names, units, keys, paths and the chip time of a full check."""
import json
import re

import pytest

from bench import common

B = common.benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
METRICS = B["end_to_end"] + B["per_layer"]
ENTRIES = ([("configs", e) for e in B["configs"]]
           + [("workloads", e) for e in B["workloads"]]
           + [("end_to_end", e) for e in B["end_to_end"]]
           + [("per_layer", e) for e in B["per_layer"]])
KEYS = {"configs": {"name", "source", "file", "reduced", "why"},
        "workloads": {"name", "config", "traffic", "chips", "why"},
        "end_to_end": {"name", "unit", "better", "bound", "source"},
        "per_layer": {"name", "unit", "better", "source", "layer", "moves"}}


def test_top_level_keys():
    assert set(B) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert len(json.dumps(B)) < 64 * 1024
    assert 1 <= len(B["command"]) <= 32
    assert all(not w.startswith("/") and ".." not in w for w in B["command"])


@pytest.mark.parametrize("kind,entry", ENTRIES,
                         ids=[e["name"] for _, e in ENTRIES])
def test_entry(kind, entry):
    assert NAME.match(entry["name"])
    extra = set(entry) - KEYS[kind]
    assert extra <= ({"workloads"} if kind in ("end_to_end", "per_layer")
                     else set())
    assert KEYS[kind] <= set(entry)
    for key in ("why", "layer", "source"):
        if key in entry and kind in ("configs", "workloads", "per_layer"):
            v = entry[key]
            assert 1 <= len(v) <= 200 and "\n" not in v and "\t" not in v
    if kind in ("end_to_end", "per_layer"):
        assert UNIT.match(entry["unit"])
        assert entry["better"] in ("lower", "higher")
    if kind == "end_to_end":
        assert entry["source"] in ("host_clock", "device_trace")
        assert 0.01 <= entry["bound"] <= 0.25
    if kind == "per_layer":
        assert entry["source"] in ("device_trace", "program_span",
                                   "program_counter", "host_clock")
        assert entry["moves"] in {m["name"] for m in B["end_to_end"]}
        assert (common.BENCH / "metrics" / f"{entry['name']}.py").is_file()
    if kind == "configs":
        assert entry["file"].startswith("bench/") and PATH.match(entry["file"])
        assert all(NAME.match(k) for k in entry["reduced"])
        conf = common.load_json(common.ROOT / entry["file"])
        assert conf["name"] == entry["name"]
        assert conf["reduced"] == entry["reduced"]
        assert (common.BENCH / "reference" / f"{conf['reference']}.py"
                ).is_file()
        assert (common.BENCH / "work" / f"{conf['work']}.py").is_file()
    if kind == "workloads":
        assert entry["chips"] in (1, 4)
        assert NAME.match(entry["traffic"]) and NAME.match(entry["config"])
        c = common.cell(entry["name"])
        assert (common.BENCH / f"drive_{c['traffic']['kind']}.py").is_file()
        assert set(c["limits"]) >= {"loss_gap", "grad_gap", "change_gap"}


def test_names_are_unique_and_used():
    for group in ("configs", "workloads"):
        names = [e["name"] for e in B[group]]
        assert len(names) == len(set(names))
    names = [m["name"] for m in METRICS]
    assert len(names) == len(set(names))
    assert {w["config"] for w in B["workloads"]} == \
        {c["name"] for c in B["configs"]}
    pairs = [(w["config"], w["traffic"]) for w in B["workloads"]]
    assert len(pairs) == len(set(pairs))
    assert "setup_s" in {m["name"] for m in B["end_to_end"]}
    cells = {w["name"] for w in B["workloads"]}
    for m in METRICS:
        assert set(m.get("workloads", cells)) <= cells


def test_layers_are_named_alike():
    layers = {}
    for m in B["per_layer"]:
        layers.setdefault(m["layer"], []).append(m["name"])
    perf = (common.ROOT / "PERF.md").read_text()
    for layer in layers:
        assert f"`{layer}`" in perf


def test_run_seconds_fit_a_full_check_of_24_cells():
    rs = B["run_seconds"]
    assert isinstance(rs, int) and 1 <= rs <= 51
    runs = 2 + 14 * 24
    assert runs * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_paths_hold_the_benchmark_alone():
    assert B["paths"] == ["bench"]
    for p in common.BENCH.rglob("*"):
        if "__pycache__" in p.parts:
            continue
        rel = p.relative_to(common.ROOT).as_posix()
        assert PATH.match(rel), rel
