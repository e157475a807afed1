"""Streaming ingest and row compaction in the port, against the JAX
package's, on the CPU.

The port runs with ``device="cpu"`` (the kernels' plain versions); the
reference runs on its host numpy path.  Every comparison is bit-exact.

Covered: ``NodeIncidence.extend``/``compact`` against a from-scratch CSR;
``EngineState.extend`` (a state grown in batches equals one built in one
shot; geometric growth) and ``compact`` (the ``RetiredLog``);
``Trace.iter_chunks`` and ``iter_swf_windows`` chunk for chunk against the
reference's, an unsorted log rejected; the ``swf-stream`` kind against
``swf`` and the reference's; streamed and compacted sessions against the
upfront, uncompacted run and the reference's stream (``RetiredLog``
payloads equal, ``light`` aggregates equal to the full ones), and a
snapshot taken across a compaction restoring in both packages.
"""
import dataclasses
import json
import pathlib

import numpy as np
import pytest

from conftest import result_dict

from repro.sched.session import SessionState as RefState
from repro.sched.session import SimSession as RefSession
from repro.sched.session import open_session as ref_open
from repro.workloads.hpc2n import iter_swf_windows as ref_iter_swf_windows
from repro.workloads.registry import WorkloadSpec as RefWorkload
from repro.workloads.registry import make_trace_ir as ref_trace
from repro.workloads.registry import stream_trace as ref_stream_trace

from repro_torch.core.alloc_kernels import NodeIncidence, build_csr
from repro_torch.core.job import JobSpec
from repro_torch.core.state import EngineState
from repro_torch.sched.engine import Engine, SimParams
from repro_torch.sched.session import SimSession, open_session
from repro_torch.workloads.hpc2n import (NODE_MEM_GB, hpc2n_preprocess,
                                         iter_swf_windows, parse_swf)
from repro_torch.workloads.registry import (WorkloadSpec, list_workloads,
                                            make_trace_ir, stream_trace)
from repro_torch.workloads.trace import COLUMNS, Trace

CPU = dict(device="cpu")
MINI = str(pathlib.Path(__file__).resolve().parent / "data" / "mini.swf")


def write_swf(path, n_jobs, seed=0, mean_gap=800.0, shuffle=False):
    """A submit-sorted synthetic swf log (the recipe of the reference's
    scale tests), written line by line."""
    rng = np.random.default_rng(seed)
    node_kb = NODE_MEM_GB * 1024 * 1024
    t, rows = 0.0, []
    for j in range(n_jobs):
        t += float(rng.exponential(mean_gap))
        f = ["-1"] * 18
        f[0] = str(j + 1)
        f[1] = f"{t:.1f}"
        f[3] = f"{rng.uniform(60.0, 6000.0):.1f}"
        f[4] = str(int(rng.integers(1, 33)))
        f[6] = f"{rng.uniform(0.05, 0.45) * node_kb:.0f}"
        rows.append(" ".join(f))
    if shuffle:
        rows[3], rows[7] = rows[7], rows[3]
    with open(path, "w") as fh:
        fh.write("; synthetic test log\n")
        for line in rows:
            fh.write(line + "\n")
    return str(path)


def _same_trace(a, b):
    assert a.fingerprint == b.fingerprint
    for name, _ in COLUMNS:
        assert np.array_equal(getattr(a, name), getattr(b, name)), name


def _spec(j, release=0.0, n_tasks=2, cpu=0.5):
    return JobSpec(jid=j, release=float(release), proc_time=100.0 + j,
                   n_tasks=n_tasks, cpu_need=cpu, mem_req=0.1)


# --------------------------------------------------------------------------- #
# structure                                                                    #
# --------------------------------------------------------------------------- #
def test_incidence_extend_and_compact_equal_a_fresh_build():
    rng = np.random.default_rng(0)
    cpu = rng.choice([0.25, 0.5, 1.0], 40)
    inc = NodeIncidence(6, cpu[:10])
    inc.extend(cpu[10:25])
    inc.extend(cpu[25:])
    maps = {}
    for j in rng.choice(40, 15, replace=False):
        maps[int(j)] = [int(n) for n in rng.integers(0, 6, 3)]
        inc.place(int(j), maps[int(j)])
    full = build_csr(cpu, [maps.get(j, []) for j in range(40)], 6)
    got = inc.csr()
    assert got.width == 40
    for name in ("indptr", "indices", "data"):
        assert np.array_equal(getattr(got, name), getattr(full, name))
    # drop the empty columns, keeping every occupied one
    keep = np.array(sorted(set(maps) | {0, 5, 39}))
    new_of_old = np.full(40, -1)
    new_of_old[keep] = np.arange(keep.size)
    inc.compact(keep, new_of_old)
    want = build_csr(cpu[keep], [maps.get(int(j), []) for j in keep], 6)
    got = inc.csr()
    assert got.width == keep.size
    for name in ("indptr", "indices", "data"):
        assert np.array_equal(getattr(got, name), getattr(want, name))


def test_state_grown_in_batches_equals_one_shot():
    specs = [_spec(j, release=10.0 * j, n_tasks=1 + j % 3) for j in range(50)]
    one = EngineState(specs, 8)
    grown = EngineState([], 8)
    for lo in range(0, 50, 7):
        assert grown.extend(specs[lo:lo + 7]) == list(range(lo, min(lo + 7,
                                                                    50)))
    for name in ("proc_time", "proc_truth", "cpu_need", "demand", "vt", "yld",
                 "penalty_until", "status", "n_pmtn", "n_mig", "gidx"):
        assert np.array_equal(getattr(one, name), getattr(grown, name)), name
    assert np.array_equal(one.completed_at, grown.completed_at,
                          equal_nan=True)
    assert np.array_equal(one.inc.cpu_need, grown.inc.cpu_need)
    assert grown.n_total == 50 and grown.first_release == 0.0
    assert grown.capacity >= 50
    assert [v.i for v in grown.views] == list(range(50))


def test_extend_growth_is_geometric():
    st = EngineState([], 4)
    for j in range(3000):
        st.extend([_spec(j, release=float(j))])
    assert st.capacity >= 3000 and len(st.specs) == 3000
    # doubling from 16: ceil(log2(3000 / 16)) + 1 = 9 grows
    assert st.grow_count <= 2 * int(np.ceil(np.log2(3000))) + 2
    assert np.array_equal(st.gidx, np.arange(3000))


def test_compact_evicts_rows_into_the_retired_log():
    specs = [_spec(j, release=float(j)) for j in range(12)]
    st = EngineState(specs, 8)
    for i in range(12):
        st.set_status(i, 1)
    for i in (1, 2, 5, 9):
        st.set_status(i, 4)
        st.completed_at[i] = 500.0 + i
    st.set_status(7, 5)                 # cancelled
    assert st.n_retired_rows == 5
    st.set_status(4, 2)
    st.inc.place(4, [0, 1])
    views = list(st.views)
    new_of_old = st.compact(protect=[9])
    assert new_of_old.tolist() == [0, -1, -1, 1, 2, -1, 3, -1, 4, 5, 6, 7]
    assert len(st.specs) == 8 and st.n_total == 12
    assert st.gidx.tolist() == [0, 3, 4, 6, 8, 9, 10, 11]
    assert views[4].i == 2 and st.views[2] is views[4]
    assert st.running_indices().tolist() == [2]
    assert st.inc.csr().indices.tolist() == [2, 2]
    ret = st.retired
    assert len(ret) == 4 and ret.n_cancelled == 1 and ret.n_completed == 3
    assert ret.col("jid").tolist() == [1, 2, 5, 7]
    assert ret.contains([2, 3, 7]) == [2, 7]
    assert st.n_retired_rows == 1       # the protected row
    assert st.compact(protect=[5]) is None


# --------------------------------------------------------------------------- #
# chunk sources                                                                #
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("seed,frac", [(4, 13.0), (1, 3.0), (0, 40.0)])
def test_iter_chunks_equal_reference(seed, frac):
    w = dict(n_jobs=300, n_nodes=32, seed=seed)
    tr = make_trace_ir(WorkloadSpec("lublin", **w))
    rtr = ref_trace(RefWorkload("lublin", **w))
    srt = tr.sorted_by_release()
    window = max((float(srt.release[-1]) - float(srt.release[0])) / frac, 1.0)
    mine, theirs = list(tr.iter_chunks(window)), list(rtr.iter_chunks(window))
    assert len(mine) == len(theirs) > 1
    for a, b in zip(mine, theirs):
        _same_trace(a, b)
    cat = np.concatenate([c.jid for c in mine])
    assert np.array_equal(cat, srt.jid)
    with pytest.raises(ValueError, match="window_s"):
        next(tr.iter_chunks(0.0))
    assert list(Trace.from_specs([]).iter_chunks(5.0)) == []


def test_trace_replace():
    tr = make_trace_ir(WorkloadSpec("lublin", n_jobs=20, n_nodes=8, seed=0))
    moved = tr.replace(release=tr.release + 7.0)
    assert np.array_equal(moved.release, tr.release + 7.0)
    assert np.array_equal(moved.jid, tr.jid)
    with pytest.raises(ValueError, match="unknown Trace columns"):
        tr.replace(colour=tr.release)


@pytest.mark.parametrize("window,n_jobs", [(43_200.0, 0), (43_200.0, 111),
                                           (7_200.0, 0), (1e9, 57)])
def test_iter_swf_windows_equal_reference_and_whole_log(tmp_path, window,
                                                        n_jobs):
    path = write_swf(tmp_path / "log.swf", 400, seed=1)
    mine = list(iter_swf_windows(path, window, n_jobs=n_jobs))
    theirs = list(ref_iter_swf_windows(path, window, n_jobs=n_jobs))
    assert [[dataclasses.astuple(s) for s in c] for c in mine] == \
        [[dataclasses.astuple(s) for s in c] for c in theirs]
    whole = hpc2n_preprocess(parse_swf(path))
    flat = [s for c in mine for s in c]
    assert flat == (whole[:n_jobs] if n_jobs else whole)


@pytest.mark.parametrize("log", ["mini", "shuffled"])
def test_an_unsorted_log_streams_in_neither_package(tmp_path, log):
    path = (MINI if log == "mini"
            else write_swf(tmp_path / "bad.swf", 20, seed=2, shuffle=True))
    with pytest.raises(ValueError, match="not sorted"):
        list(iter_swf_windows(path, 3600.0))
    with pytest.raises(ValueError, match="not sorted"):
        list(ref_iter_swf_windows(path, 3600.0))
    with pytest.raises(ValueError, match="window_s"):
        list(iter_swf_windows(path, 0.0))
    # the materialized fallback of the kind sorts, as 'swf' does
    kw = dict(n_jobs=0, n_nodes=16, params={"path": path})
    _same_trace(make_trace_ir(WorkloadSpec("swf-stream", **kw)),
                ref_trace(RefWorkload("swf-stream", **kw)))


@pytest.mark.parametrize("seed,n_jobs", [(3, 0), (6, 150)])
def test_swf_stream_kind_equals_swf_and_reference(tmp_path, seed, n_jobs):
    path = write_swf(tmp_path / "l.swf", 300, seed=seed)
    kw = dict(n_jobs=n_jobs, n_nodes=16,
              params={"path": path, "window": 20_000.0})
    assert "swf-stream" in list_workloads()
    mat = make_trace_ir(WorkloadSpec("swf", n_jobs=n_jobs, n_nodes=16,
                                     params={"path": path}))
    _same_trace(make_trace_ir(WorkloadSpec("swf-stream", **kw)), mat)
    mine = list(stream_trace(WorkloadSpec("swf-stream", **kw)))
    theirs = list(ref_stream_trace(RefWorkload("swf-stream", **kw)))
    assert len(mine) == len(theirs)
    for a, b in zip(mine, theirs):
        _same_trace(a, b)
    assert np.array_equal(np.concatenate([c.jid for c in mine]), mat.jid)


def test_stream_trace_falls_back_to_iter_chunks_for_lublin_and_tpu():
    """Kinds without a native streamer (Lublin, and the tpu job mix, which
    is ported now) stream through ``iter_chunks``."""
    for w in (WorkloadSpec("lublin", n_jobs=80, n_nodes=16, seed=2),
              WorkloadSpec("tpu", n_jobs=80, n_nodes=32, seed=2)):
        a = list(stream_trace(w, window_s=3600.0))
        b = list(make_trace_ir(w).iter_chunks(3600.0))
        assert len(a) == len(b) > 1
        for x, y in zip(a, b):
            _same_trace(x, y)


# --------------------------------------------------------------------------- #
# streamed + compacted sessions                                                #
# --------------------------------------------------------------------------- #
STREAM_POLICIES = ["GreedyP */OPT=MIN", "EASY",
                   "GreedyPM */per/OPT=MIN/MINVT=600", "Greedy */OPT=AVG",
                   "EASY+OPT=MIN", "/stretch-per/OPT=MAX"]


@pytest.mark.parametrize("policy", STREAM_POLICIES)
def test_streamed_compacted_run_equals_upfront_and_reference(policy):
    w = dict(n_jobs=80, n_nodes=16, seed=5, load=0.9)
    tr = make_trace_ir(WorkloadSpec("lublin", **w))
    rtr = ref_trace(RefWorkload("lublin", **w))
    window = (float(tr.release.max()) - float(tr.release.min())) / 9.0
    upfront = Engine(tr, policy, SimParams(n_nodes=16)).run()
    ses = open_session(SimParams(n_nodes=16, compact_interval=8), policy,
                       **CPU)
    ref = ref_open(16, policy, compact_interval=8)
    ses.stream(tr.iter_chunks(window))
    ref.stream(rtr.iter_chunks(window))
    st = ses.engine.state
    assert len(st.retired) == 80 and len(st.specs) == 0
    assert json.dumps(st.retired.payload()) == \
        json.dumps(ref.engine.state.retired.payload())
    r = ses.result()
    assert result_dict(r) == result_dict(upfront)
    assert result_dict(r) == result_dict(ref.result())
    light = ses.result(light=True)
    assert light.completions == {} and light.stretches == {}
    assert {k: v for k, v in result_dict(light).items()
            if k not in ("completions", "stretches")} == \
        {k: v for k, v in result_dict(r).items()
         if k not in ("completions", "stretches")}


def test_streamed_swf_session_equals_upfront_and_reference(tmp_path):
    path = write_swf(tmp_path / "log.swf", 1500, seed=0)
    kw = dict(n_jobs=1200, n_nodes=64, params={"path": path})
    policy = "GreedyP */OPT=MIN"
    upfront = Engine(make_trace_ir(WorkloadSpec("swf", **kw)), policy,
                     SimParams(n_nodes=64)).run()
    ses = open_session(SimParams(n_nodes=64, compact_interval=128), policy,
                       **CPU)
    peak = []

    def watched(chunks):
        for c in chunks:
            peak.append(len(ses.engine.state.specs))
            yield c

    ses.stream(watched(stream_trace(WorkloadSpec("swf-stream", **kw),
                                    window_s=86400.0)))
    ref = ref_open(64, policy, compact_interval=128)
    ref.stream(ref_stream_trace(RefWorkload("swf-stream", **kw),
                                window_s=86400.0))
    r = ses.result()
    assert result_dict(r) == result_dict(upfront)
    assert result_dict(r) == result_dict(ref.result())
    assert len(peak) > 5 and max(peak) < 600
    st = ses.engine.state
    assert st.grow_count == ref.engine.state.grow_count
    assert st.capacity == ref.engine.state.capacity


def test_compact_now_and_events_unchanged():
    w = WorkloadSpec("lublin", n_jobs=60, n_nodes=16, seed=7, load=1.1)
    tr = make_trace_ir(w)
    ses = open_session(16, "GreedyP */OPT=MIN", **CPU)
    ses.submit(tr)
    ses.step(40)
    n = ses.compact()
    assert n == len(ses.engine.state.retired) > 0
    assert ses.compact() == 0
    r = ses.run()
    assert result_dict(r) == result_dict(
        Engine(tr, "GreedyP */OPT=MIN", SimParams(n_nodes=16)).run())
    # a compacted-away jid is still a duplicate
    with pytest.raises(ValueError, match="duplicate job ids"):
        ses.submit(tr.select(np.arange(1)), shift="now")


def test_snapshot_across_compaction_crosses_between_packages(tmp_path):
    w = dict(n_jobs=70, n_nodes=16, seed=4, load=1.0)
    tr = make_trace_ir(WorkloadSpec("lublin", **w))
    rtr = ref_trace(RefWorkload("lublin", **w))
    policy = "GreedyPM */per/OPT=MIN/MINVT=600"
    ses = open_session(SimParams(n_nodes=16, compact_interval=10), policy,
                       **CPU)
    ref = ref_open(16, policy, compact_interval=10)
    ses.submit(tr)
    ref.submit(rtr)
    ses.step(60)
    ref.step(60)
    assert len(ses.engine.state.retired) > 0
    ses._wall = ref._wall = 0.0
    mine, theirs = ses.snapshot(), ref.snapshot()
    assert mine.fingerprint == theirs.fingerprint
    path = str(tmp_path / "snap.json")
    mine.save(path)
    ref_cont = RefSession.restore(path)
    port_cont = SimSession.restore(RefState.from_json_dict(
        theirs.to_json_dict()).to_json_dict(), **CPU)
    want = result_dict(Engine(tr, policy, SimParams(n_nodes=16)).run())
    assert result_dict(port_cont.run()) == want
    assert result_dict(ref_cont.run()) == want
    assert result_dict(ses.run()) == want
