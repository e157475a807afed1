"""What-if branches in the port (``repro_torch.sched.sweep.run_branches``)
against the JAX package's serial ``run_branches``, on the CPU.

The port races its branches in lockstep on ``device="cpu"`` (one
``LockstepDispatcher`` over one ``TorchBatchedAllocator``, the kernels'
plain versions); the reference runs them one after another on its host
numpy path (its ``backend=None``), with no JAX involved.  Records must be
equal field for field (bit-exact), the wall-clock fields and the
``backend`` tag aside.
"""
import pytest

from repro.sched.engine import Engine as RefEngine
from repro.sched.engine import SimParams as RefParams
from repro.sched.session import SimSession as RefSession
from repro.sched.sweep import run_branches as ref_run_branches
from repro.workloads.registry import WorkloadSpec as RefWorkload
from repro.workloads.registry import make_trace_ir as ref_trace

from repro_torch.sched.session import SessionState, open_session
from repro_torch.sched.sweep import run_branches
from repro_torch.workloads.registry import WorkloadSpec, make_trace_ir

CPU = dict(device="cpu")
_CLOCKS = ("wall_s", "sim_wall_s", "backend")

BRANCHES = ["GreedyP */OPT=MIN", "GreedyPM */OPT=MIN", "Greedy */OPT=AVG",
            "GreedyPM */per/OPT=MIN/MINVT=600",
            {"policy": "GreedyPM */per/OPT=MIN/MINVT=600", "period": 1200.0},
            "/per/OPT=MIN", "EASY+OPT=MIN", "EASY", "FCFS"]


def _outcomes(records):
    return [{k: v for k, v in r.items() if k not in _CLOCKS}
            for r in records]


def _snapshot(n_jobs=60, n_nodes=16, seed=0, at=30, events=True):
    """A mid-run snapshot of a GreedyP */OPT=MIN session with a node
    failure and a join injected ahead (the card's phase, in small)."""
    ses = open_session(n_nodes, "GreedyP */OPT=MIN", **CPU)
    ses.submit(make_trace_ir(WorkloadSpec("lublin", n_jobs=n_jobs,
                                          n_nodes=n_nodes, seed=seed,
                                          load=0.9)))
    ses.step_until(ses.engine.state.specs[at].release)
    if events:
        ses.inject({"kind": "fail", "t": ses.now + 600.0,
                    "nodes": list(range(n_nodes // 8))})
        ses.inject({"kind": "join", "t": ses.now + 7200.0,
                    "nodes": list(range(n_nodes // 8))})
    ses._wall = 0.0                     # a measurement, not state
    return ses, ses.snapshot()


@pytest.mark.parametrize("seed", [0, 3])
def test_lockstep_branches_equal_reference_serial_branches(seed):
    ses, snap = _snapshot(seed=seed)
    res = run_branches(snap, BRANCHES, **CPU)
    ref = ref_run_branches(snap.to_json_dict(), BRANCHES)
    assert _outcomes(res.records) == _outcomes(ref.records)
    assert [r["backend"] for r in res.records] == ["torch"] * len(BRANCHES)
    assert res.records[0]["exact_continuation"]
    assert not any(r["exact_continuation"] for r in res.records[1:])
    # the same-policy branch is the uninterrupted continuation
    cont = ses.run()
    r0 = res.records[0]
    assert (r0["max_stretch"], r0["events"], r0["final_time"]) == \
        (cont.max_stretch, cont.events, cont.final_time)
    # batch forks drop the cluster script and revive the dead nodes
    assert all(not r["partial"] for r in res.records)
    assert res.alloc_stats["dispatches"] > 0


def test_lockstep_rounds_do_not_depend_on_thread_timing():
    _, snap = _snapshot(seed=1)
    a = run_branches(snap, BRANCHES, **CPU)
    b = run_branches(snap, BRANCHES, **CPU)
    assert _outcomes(a.records) == _outcomes(b.records)
    for key in ("dispatches", "rounds", "host_syncs"):
        assert a.alloc_stats[key] == b.alloc_stats[key], key
    assert a.alloc_stats["min_shapes"] == b.alloc_stats["min_shapes"]
    assert a.alloc_stats["avg_shapes"] == b.alloc_stats["avg_shapes"]


def test_serial_host_path_equals_lockstep():
    _, snap = _snapshot(seed=2)
    host = run_branches(snap, BRANCHES, backend="numpy")
    dev = run_branches(snap, BRANCHES, **CPU)
    assert _outcomes(host.records) == _outcomes(dev.records)
    assert "backend" not in host.records[0]
    with pytest.raises(ValueError, match="backend"):
        run_branches(snap, BRANCHES, backend="jax")


@pytest.mark.parametrize("horizon", [1800.0, 20000.0])
def test_horizon_equals_reference(horizon):
    _, snap = _snapshot(seed=4)
    res = run_branches(snap, BRANCHES, horizon_s=horizon, **CPU)
    ref = ref_run_branches(snap.to_json_dict(), BRANCHES, horizon_s=horizon)
    assert _outcomes(res.records) == _outcomes(ref.records)
    if horizon < 5000.0:
        assert all(r["partial"] for r in res.records
                   if r["policy"] not in ("EASY", "FCFS"))


def test_early_stop_equals_reference():
    _, snap = _snapshot(n_jobs=80, seed=5, at=20)
    stop = {"max_stretch_above": 3.0}
    res = run_branches(snap, BRANCHES, early_stop=stop, **CPU)
    ref = ref_run_branches(snap.to_json_dict(), BRANCHES, early_stop=stop)
    assert _outcomes(res.records) == _outcomes(ref.records)
    assert any(r["early_stopped"] for r in res.records)


def test_snapshot_from_the_reference_and_a_file(tmp_path):
    tr = ref_trace(RefWorkload("lublin", n_jobs=50, n_nodes=16, seed=6,
                               load=0.9))
    ses = RefSession.from_engine(RefEngine(tr, "GreedyPM */OPT=MIN",
                                           RefParams(n_nodes=16)))
    ses.step(25)
    path = str(tmp_path / "snap.json")
    ses.snapshot().save(path)
    pols = ["GreedyPM */OPT=MIN", "EASY", "MCB8 */OPT=MIN/MINVT=600"]
    res = run_branches(path, pols, **CPU)
    ref = ref_run_branches(path, pols)
    assert _outcomes(res.records) == _outcomes(ref.records)
    assert res.records[0]["exact_continuation"]
    again = run_branches(SessionState.load(path).to_json_dict(), pols[:1],
                         **CPU)
    assert _outcomes(again.records) == _outcomes(res.records[:1])


def test_a_crashing_branch_is_quarantined_or_raises():
    _, snap = _snapshot(seed=7)
    bad = ["GreedyP */OPT=MIN", "NoSuchPolicy", "EASY"]
    res = run_branches(snap, bad, quarantine=True, **CPU)
    assert [r.get("quarantined", False) for r in res.records] == \
        [False, True, False]
    assert "NoSuchPolicy" in res.records[1]["error"]
    with pytest.raises(ValueError):
        run_branches(snap, bad, **CPU)
    host = run_branches(snap, bad, quarantine=True, backend="numpy")
    assert _outcomes(host.records)[1] == _outcomes(res.records)[1]


def test_branch_seed_is_recorded_and_supervision_is_not_ported():
    """``branch_seed`` is recorded (with no narrator it reseeds nothing);
    supervision is ported now: ``timeout_s``/``retries`` quarantine a
    failed lane on the device path and supervise worker processes on the
    host path, with the reference's records."""
    _, snap = _snapshot(seed=8)
    res = run_branches(snap, ["GreedyP */OPT=MIN"], branch_seed=11, **CPU)
    assert res.records[0]["branch_seed"] == 11
    assert not res.records[0]["exact_continuation"]
    plain = run_branches(snap, ["GreedyP */OPT=MIN"], **CPU).records[0]
    assert res.records[0]["max_stretch"] == plain["max_stretch"]
    pols = ["EASY", "NoSuchPolicy"]
    ref = ref_run_branches(snap.to_json_dict(), pols, quarantine=True)
    for kw in ({"timeout_s": 30.0}, {"retries": 1}):
        dev = run_branches(snap, pols, **kw, **CPU)
        host = run_branches(snap, pols, **kw, backend="numpy")
        for got in (dev, host):
            assert [bool(r.get("quarantined")) for r in got.records] == \
                [False, True]
            assert _outcomes(got.records[:1]) == _outcomes(ref.records[:1])
        assert host.records[1]["attempts"] == 1 + kw.get("retries", 0)
    assert run_branches(snap, [], **CPU).records == []
