"""The port's workload registry and its HPC2N / swf / tpu kinds
(``repro_torch.workloads.registry``, ``repro_torch.workloads.hpc2n``,
``repro_torch.workloads.jobgen``) against the JAX package's: equal traces
(fingerprints and columns) over seeds and sizes, the swf fixture parsed
and preprocessed the same way, the prefix cap and the cluster-width filter
applied alike, roofline records turned into the same job types, and the
registry's knob contract enforced alike.
"""
import dataclasses
import json
import pathlib

import numpy as np
import pytest

from repro.workloads.hpc2n import hpc2n_like_trace as ref_hpc2n_like
from repro.workloads.hpc2n import hpc2n_preprocess as ref_preprocess
from repro.workloads.hpc2n import parse_swf as ref_parse_swf
from repro.workloads import jobgen as ref_jobgen
from repro.workloads.registry import WorkloadSpec as RefWorkload
from repro.workloads.registry import make_trace_ir as ref_trace
from repro.workloads.registry import parse_workload as ref_parse_workload

from repro_torch.workloads.hpc2n import (N_NODES, NODE_MEM_GB,
                                         hpc2n_like_trace, hpc2n_preprocess,
                                         iter_swf, parse_swf)
from repro_torch.workloads import jobgen
from repro_torch.workloads.registry import (WorkloadSpec, list_workloads,
                                            make_trace_ir, parse_workload,
                                            register_workload, workload_kind)
from repro_torch.workloads.trace import COLUMNS, Trace

MINI = str(pathlib.Path(__file__).resolve().parent / "data" / "mini.swf")


def _same_trace(a, b):
    assert a.fingerprint == b.fingerprint
    for name, _ in COLUMNS:
        assert np.array_equal(getattr(a, name), getattr(b, name)), name


def test_hpc2n_constants():
    assert (NODE_MEM_GB, N_NODES) == (2.0, 120)


@pytest.mark.parametrize("n_jobs,n_nodes,seed", [
    (50, 16, 0), (200, 64, 1), (300, 128, 2), (1000, 128, 0), (120, 8, 7),
    (500, 120, 11)])
def test_hpc2n_trace_equals_reference(n_jobs, n_nodes, seed):
    got = make_trace_ir(WorkloadSpec("hpc2n", n_jobs=n_jobs,
                                     n_nodes=n_nodes, seed=seed))
    ref = ref_trace(RefWorkload("hpc2n", n_jobs=n_jobs, n_nodes=n_nodes,
                                seed=seed))
    _same_trace(got, ref)
    assert (got.n_tasks <= n_nodes).all()


@pytest.mark.parametrize("seed,span", [(0, 1.0), (3, 0.5), (9, 4.0)])
def test_hpc2n_like_specs_equal_reference(seed, span):
    got = hpc2n_like_trace(n_jobs=150, seed=seed, span_weeks=span)
    ref = ref_hpc2n_like(n_jobs=150, seed=seed, span_weeks=span)
    assert [dataclasses.astuple(s) for s in got] == \
        [dataclasses.astuple(s) for s in ref]


def test_parse_swf_equals_reference():
    got = parse_swf(MINI)
    ref = ref_parse_swf(MINI)
    fields = ("jid", "submit", "run", "procs", "used_mem_kb", "req_mem_kb")
    assert [[getattr(j, f) for f in fields] for j in got] == \
        [[getattr(j, f) for f in fields] for j in ref]
    # rows with run <= 0, procs <= 0 or short lines are skipped
    assert len(got) == 10
    text = open(MINI).read()
    assert [j.jid for j in iter_swf(text)] == [j.jid for j in got]


def test_preprocess_equals_reference():
    got = hpc2n_preprocess(parse_swf(MINI))
    ref = ref_preprocess(ref_parse_swf(MINI))
    assert [dataclasses.astuple(s) for s in got] == \
        [dataclasses.astuple(s) for s in ref]
    # jids re-assigned in submit order
    assert [s.jid for s in got] == list(range(len(got)))
    assert [s.release for s in got] == sorted(s.release for s in got)


@pytest.mark.parametrize("n_jobs,n_nodes", [(0, 16), (0, 200), (5, 16),
                                            (8, 200), (3, 4)])
def test_swf_kind_equals_reference(n_jobs, n_nodes):
    """The prefix cap (n_jobs, 0 = whole log) and the drop of jobs wider
    than the cluster (the 128-proc row at 16 nodes)."""
    got = make_trace_ir(parse_workload(f"swf:{MINI}", n_jobs=n_jobs,
                                       n_nodes=n_nodes))
    ref = ref_trace(ref_parse_workload(f"swf:{MINI}", n_jobs=n_jobs,
                                       n_nodes=n_nodes))
    _same_trace(got, ref)
    full = len(parse_swf(MINI))
    cap = n_jobs if n_jobs else full
    assert len(got) <= cap
    assert (got.n_tasks <= n_nodes).all()


def test_swf_prefix_and_width_filter_act():
    whole = make_trace_ir(parse_workload(f"swf:{MINI}", n_jobs=0,
                                         n_nodes=200))
    narrow = make_trace_ir(parse_workload(f"swf:{MINI}", n_jobs=0,
                                          n_nodes=16))
    capped = make_trace_ir(parse_workload(f"swf:{MINI}", n_jobs=5,
                                          n_nodes=200))
    assert len(whole) == 10 and len(narrow) == 9 and len(capped) == 5


def test_registry_lists_the_ported_kinds():
    kinds = set(list_workloads())
    assert {"hpc2n", "lublin", "swf", "swf-stream", "tpu"} <= kinds
    assert workload_kind("tpu").supports_load
    assert workload_kind("tpu").params == ("records", "chips_per_task")
    assert workload_kind("lublin").supports_load
    assert workload_kind("swf").path_param == "path"


@pytest.mark.parametrize("kind", ["tpu"])
def test_tpu_kind_keeps_the_reference_knob_contract(kind):
    """Every kind is ported now: the former one keeps the reference's knob
    contract (no path argument, no ``path`` param) instead."""
    for make in (RefWorkload, WorkloadSpec):
        with pytest.raises(ValueError, match="does not accept"):
            make(kind, params={"path": MINI})
    with pytest.raises(ValueError, match="takes no"):
        ref_parse_workload(f"{kind}:{MINI}")
    with pytest.raises(ValueError, match="takes no"):
        parse_workload(f"{kind}:{MINI}")


@pytest.mark.parametrize("size", [(80, 32, 0, None), (80, 32, 3, 0.9),
                                  (120, 16, 1, 0.6), (40, 2, 2, None)])
def test_tpu_kind_equals_reference(size):
    n_jobs, n_nodes, seed, load = size
    kw = dict(n_jobs=n_jobs, n_nodes=n_nodes, seed=seed, load=load)
    got = make_trace_ir(WorkloadSpec("tpu", **kw))
    _same_trace(got, ref_trace(RefWorkload("tpu", **kw)))
    assert len(got) == n_jobs and (got.n_tasks <= n_nodes).all()


#: roofline records in the dry run's format (one per arch x shape cell);
#: the last has no dominant term and yields no job type
RECORDS = [
    {"arch": "llama3-8b", "shape": "train_4k", "compute_s": 0.91,
     "memory_s": 0.40, "collective_s": 0.22, "bytes_per_device": 12.5e9,
     "n_chips": 256},
    {"arch": "rwkv6-7b", "shape": "decode_32k", "compute_s": 0.002,
     "memory_s": 0.011, "collective_s": 0.001, "bytes_per_device": 9.1e9,
     "n_chips": 16},
    {"arch": "whisper", "shape": "prefill_1k", "compute_s": 0.05,
     "memory_s": 0.02, "collective_s": 0.06, "bytes_per_device": 1.0e8},
    {"arch": "empty", "shape": "none", "compute_s": 0.0, "memory_s": 0.0,
     "collective_s": 0.0, "bytes_per_device": 0.0},
]


def test_tpu_job_types_equal_reference():
    assert jobgen.HBM_BYTES == ref_jobgen.HBM_BYTES
    assert ([dataclasses.astuple(t) for t in jobgen.DEFAULT_TPU_JOB_TYPES]
            == [dataclasses.astuple(t)
                for t in ref_jobgen.DEFAULT_TPU_JOB_TYPES])
    for cpt in (16, 4):
        mine = jobgen.tpu_job_types(RECORDS, chips_per_task=cpt)
        theirs = ref_jobgen.tpu_job_types(RECORDS, chips_per_task=cpt)
        assert len(mine) == 3
        assert ([dataclasses.astuple(t) for t in mine]
                == [dataclasses.astuple(t) for t in theirs])
    with pytest.raises(ValueError, match="no job types fit"):
        jobgen.tpu_trace(jobgen.DEFAULT_TPU_JOB_TYPES[:1], n_nodes=8)


@pytest.mark.parametrize("chips_per_task", [None, 8])
def test_tpu_records_file_equals_reference(tmp_path, chips_per_task):
    path = tmp_path / "roofline.json"
    path.write_text(json.dumps(RECORDS))
    params = {"records": str(path)}
    if chips_per_task is not None:
        params["chips_per_task"] = chips_per_task
    kw = dict(n_jobs=80, n_nodes=32, seed=4, load=0.7, params=params)
    got = make_trace_ir(WorkloadSpec("tpu", **kw))
    _same_trace(got, ref_trace(RefWorkload("tpu", **kw)))
    default = make_trace_ir(WorkloadSpec("tpu", n_jobs=80, n_nodes=32,
                                         seed=4, load=0.7))
    assert got.fingerprint != default.fingerprint


@pytest.mark.parametrize("make", [
    lambda m: m("nope"),
    lambda m: m("hpc2n", load=0.7),
    lambda m: m("swf"),
    lambda m: m("lublin", params={"path": "x"}),
    lambda m: m("swf", params={"path": ["not", "a", "scalar"]}),
])
def test_knob_contract_rejects_like_the_reference(make):
    with pytest.raises(ValueError):
        make(RefWorkload)
    with pytest.raises(ValueError):
        make(WorkloadSpec)


def test_parse_workload_grammar_equals_reference():
    for text in ("lublin", "hpc2n", f"swf:{MINI}"):
        got = parse_workload(text, n_jobs=20, n_nodes=16, seed=3)
        ref = ref_parse_workload(text, n_jobs=20, n_nodes=16, seed=3)
        assert got.to_dict() == ref.to_dict()
        assert got.name == ref.name
    with pytest.raises(ValueError, match="takes no"):
        parse_workload("lublin:x")


def test_register_workload_adds_a_kind():
    name = "test-torch-constant"
    if name not in list_workloads():
        @register_workload(name, params=("width",))
        def _constant(spec):
            """every job one task wide"""
            base = make_trace_ir(WorkloadSpec("lublin", n_jobs=spec.n_jobs,
                                              n_nodes=spec.n_nodes,
                                              seed=spec.seed))
            return base.select(base.n_tasks <= int(spec.param("width", 1)))
    spec = WorkloadSpec(name, n_jobs=30, n_nodes=8, params={"width": 1})
    tr = make_trace_ir(spec)
    assert isinstance(tr, Trace) and (tr.n_tasks == 1).all()
    assert workload_kind(name).doc == "every job one task wide"
    with pytest.raises(ValueError, match="already registered"):
        register_workload(name)(lambda s: None)
