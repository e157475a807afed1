"""The port's open sessions (``repro_torch.sched.session``) against the JAX
package's, on the CPU.

The port runs with ``device="cpu"`` (the kernels' plain versions behind
``TorchAllocBackend``); the reference runs on its host numpy path, with no
JAX involved.  Every comparison is bit-exact: equal ``SimResult`` fields
(the wall-clock ``sim_wall_s`` aside), equal ``observe()`` dicts between
steps, equal snapshot payloads and fingerprints at the same event
boundary.  A payload's ``wall_s`` is the engine loop's wall-clock time, a
measurement and not simulation state, so the two sessions' loop clocks
are zeroed before a payload comparison.

Covered: split runs at seeded random ``step``/``step_until`` boundaries
over the Table-1 policies and EASY/FCFS; ``submit`` in batches and with
``shift="now"``; ``inject`` of fail/join/cancel/resize/period and its
validation; snapshots that cross between the packages both ways; ``fork``
as an exact continuation and onto batch and periodic compositions; the
lifecycle; and the parts not ported yet, which raise.
"""
import dataclasses
import json
import math

import numpy as np
import pytest

from conftest import result_dict

from repro.core.policies import TABLE1_POLICIES
from repro.sched.engine import Engine as RefEngine
from repro.sched.engine import SimParams as RefParams
from repro.sched.session import SessionState as RefState
from repro.sched.session import SimSession as RefSession
from repro.sched.session import open_session as ref_open
from repro.workloads.registry import WorkloadSpec as RefWorkload
from repro.workloads.registry import make_trace_ir as ref_trace

from repro_torch.core.alloc_torch import TorchAllocBackend
from repro_torch.sched.cluster import ClusterEvent
from repro_torch.sched.engine import Engine, SimParams
from repro_torch.sched.session import (SNAPSHOT_VERSION, SessionState,
                                       SimSession, open_session)
from repro_torch.sched.narrator import parse_narrator
from repro_torch.tune import AutoTuner
from repro_torch.workloads.registry import WorkloadSpec, make_trace_ir

CPU = dict(device="cpu")


def _traces(n_jobs, n_nodes, seed, load=None):
    w = dict(n_jobs=n_jobs, n_nodes=n_nodes, seed=seed, load=load)
    return (make_trace_ir(WorkloadSpec("lublin", **w)),
            ref_trace(RefWorkload("lublin", **w)))


def _pair(policy, n_jobs=50, n_nodes=16, seed=0, load=None, events=()):
    """The same cell as a port session (on the torch backend, CPU) and a
    reference session, both adopting a fully built engine."""
    tr, rtr = _traces(n_jobs, n_nodes, seed, load)
    ev = [ClusterEvent(*e) for e in events]
    from repro.sched.cluster import ClusterEvent as RefEvent
    rev = [RefEvent(*e) for e in events]
    ses = SimSession.from_engine(Engine(
        tr, policy, SimParams(n_nodes=n_nodes), cluster_events=ev,
        alloc_backend=TorchAllocBackend(**CPU)))
    ref = RefSession.from_engine(RefEngine(
        rtr, policy, RefParams(n_nodes=n_nodes), cluster_events=rev))
    return ses, ref


def _zero_walls(*sessions):
    for s in sessions:
        s._wall = 0.0


def _payload_text(snap):
    return json.dumps(snap.payload, sort_keys=True)


def _same_snapshot(ses, ref):
    """Both sessions' snapshots at this boundary are equal, text and
    fingerprint (loop clocks zeroed first)."""
    _zero_walls(ses, ref)
    a, b = ses.snapshot(), ref.snapshot()
    assert _payload_text(a) == _payload_text(b)
    assert a.fingerprint == b.fingerprint
    return a, b


def _random_schedule(rng, t0, span):
    ops = []
    for _ in range(int(rng.integers(2, 7))):
        if rng.random() < 0.5:
            ops.append(("until", t0 + float(rng.uniform(0.0, 1.1)) * span))
        else:
            ops.append(("step", int(rng.integers(1, 12))))
    return ops


def _apply(ses, op):
    kind, arg = op
    if kind == "until":
        # step_until never goes back: a bound behind the clock is a no-op
        return ses.step_until(max(arg, ses.now))
    return ses.step(arg)


SPLIT_POLICIES = list(TABLE1_POLICIES) + ["FCFS", "EASY"]


@pytest.mark.parametrize("k,policy", list(enumerate(SPLIT_POLICIES)),
                         ids=SPLIT_POLICIES)
def test_split_run_equals_engine_run_and_reference(k, policy):
    n_nodes = 8 if k % 2 else 16
    ses, ref = _pair(policy, n_jobs=40 + 10 * (k % 5), n_nodes=n_nodes,
                     seed=k, load=1.1)
    tr, _ = _traces(40 + 10 * (k % 5), n_nodes, k, 1.1)
    whole = Engine(tr, policy, SimParams(n_nodes=n_nodes)).run()
    rng = np.random.default_rng(100 + k)
    span = whole.final_time - float(tr.release.min())
    for op in _random_schedule(rng, float(tr.release.min()), span):
        assert _apply(ses, op) == _apply(ref, op)
        assert ses.observe() == ref.observe()
    got = result_dict(ses.run())
    assert got == result_dict(ref.run())
    assert got == result_dict(whole)


def test_step_until_does_not_advance_the_engine_clock():
    ses, ref = _pair("FCFS", n_jobs=25)
    t0 = ses.next_event_time()
    assert ses.step_until(t0 + 1.0) == ref.step_until(t0 + 1.0) == t0 + 1.0
    assert ses.engine.state.now == ref.engine.state.now <= t0 + 1.0
    assert ses.next_event_time() == ref.next_event_time()


def test_submit_in_batches_equals_one_shot_and_reference():
    tr, rtr = _traces(60, 16, 2)
    whole = Engine(tr, "GreedyPM */OPT=MIN", SimParams(n_nodes=16)).run()
    ses = open_session(16, "GreedyPM */OPT=MIN", **CPU)
    ref = ref_open(16, "GreedyPM */OPT=MIN")
    srt, rsrt = tr.sorted_by_release(), rtr.sorted_by_release()
    for lo in range(0, 60, 15):
        idx = np.arange(lo, lo + 15)
        assert ses.submit(srt.select(idx)) == ref.submit(rsrt.select(idx))
        bound = float(srt.release[min(lo + 15, 59)])
        ses.step_until(bound)
        ref.step_until(bound)
        assert ses.observe() == ref.observe()
    r = ses.run()
    assert result_dict(r) == result_dict(ref.run())
    # a batch submitted before its releases is the closed-world run
    assert r.completions == whole.completions
    assert ses.engine.state.grow_count == ref.engine.state.grow_count


def test_submit_shift_now_and_validation():
    tr, rtr = _traces(30, 16, 4)
    ses = open_session(16, "GreedyP */OPT=MIN", **CPU)
    ref = ref_open(16, "GreedyP */OPT=MIN")
    half = np.arange(15)
    rest = np.arange(15, 30)
    ses.submit(tr.select(half))
    ref.submit(rtr.select(half))
    ses.run_to_exhaustion()
    ref.run_to_exhaustion()
    assert ses.exhausted and ref.exhausted
    # history is immutable: an old release is refused unless shifted
    with pytest.raises(ValueError, match="shift='now'"):
        ses.submit(tr.select(rest).replace(release=np.zeros(15)))
    with pytest.raises(ValueError, match="duplicate job ids"):
        ses.submit(tr.select(half), shift="now")
    assert ses.submit(tr.select(rest), shift="now") == \
        ref.submit(rtr.select(rest), shift="now")
    assert not ses.exhausted
    assert min(s.release for s in ses.engine.state.specs[15:]) == ses.now
    ses.submit(tr.select(np.arange(0)))
    assert result_dict(ses.run()) == result_dict(ref.run())


def test_submit_workload_spec_and_float_shift():
    w = WorkloadSpec("lublin", n_jobs=20, n_nodes=8, seed=5)
    rw = RefWorkload("lublin", n_jobs=20, n_nodes=8, seed=5)
    ses = open_session(8, "Greedy */OPT=AVG", **CPU)
    ref = ref_open(8, "Greedy */OPT=AVG")
    ses.submit(w, shift=100.0)
    ref.submit(rw, shift=100.0)
    assert result_dict(ses.run()) == result_dict(ref.run())


INJECTS = [
    {"kind": "fail", "dt": 10.0, "nodes": [0, 1, 2]},
    {"kind": "join", "dt": 900.0, "nodes": [0, 1, 2]},
    {"kind": "cancel", "dt": 20.0, "jid": "running"},
    {"kind": "resize", "dt": 30.0, "jid": "pending", "value": 2},
    {"kind": "period", "period": 120.0},
]


@pytest.mark.parametrize("policy", ["GreedyP */OPT=MIN",
                                    "GreedyPM */per/OPT=MIN/MINVT=600",
                                    "MCB8/per/OPT=MIN/MINVT=600",
                                    "Greedy */OPT=AVG"])
def test_inject_every_kind_equals_reference(policy):
    ses, ref = _pair(policy, n_jobs=60, n_nodes=16, seed=8, load=1.4)
    ses.step(25)
    ref.step(25)
    st = ses.engine.state
    running = [s.jid for s, c in zip(st.specs, st.status) if c == 2]
    pending = [s.jid for s, c in zip(st.specs, st.status) if c in (0, 1)]
    t = ses.now
    for ev in INJECTS:
        ev = dict(ev)
        if "dt" in ev:
            ev["t"] = t + ev.pop("dt")
        if ev.get("jid") == "running":
            ev["jid"] = running[0]
        elif ev.get("jid") == "pending":
            ev["jid"] = pending[-1]
        ses.inject(dict(ev))
        ref.inject(dict(ev))
    assert ses.engine.params.period == 120.0
    _same_snapshot(ses, ref)
    ses.step_until(t + 50.0)
    ref.step_until(t + 50.0)
    assert ses.observe() == ref.observe()
    r = ses.run()
    assert result_dict(r) == result_dict(ref.run())
    assert r.n_cancelled == 1


def test_inject_validation_matches_reference():
    ses, ref = _pair("GreedyP */OPT=MIN", n_jobs=30, n_nodes=8, seed=1)
    ses.step(12)
    ref.step(12)
    now = ses.now
    done = next(s.jid for s, c in zip(ses.engine.state.specs,
                                      ses.engine.state.status) if c == 4)
    bad = [
        ({"kind": "fail", "t": now + 1, "nodes": [99]}, "outside"),
        ({"kind": "fail", "t": ses.engine.state.now - 50.0, "nodes": [0]},
         "clock"),
        ({"kind": "join", "t": now + 1, "nodes": [0]}, "already alive"),
        ({"kind": "cancel", "t": now + 1, "jid": 10 ** 6}, "unknown job"),
        ({"kind": "cancel", "t": now + 1, "jid": done}, "already completed"),
        ({"kind": "period", "period": 0.0}, "period must be > 0"),
    ]
    for ev, msg in bad:
        for s in (ses, ref):
            with pytest.raises(ValueError, match=msg):
                s.inject(dict(ev))
    for s in (ses, ref):
        s.inject({"kind": "fail", "t": now + 5, "nodes": [3]})
        with pytest.raises(ValueError, match="already dead"):
            s.inject({"kind": "fail", "t": now + 6, "nodes": [3]})
        s.inject({"kind": "cancel", "t": now + 5, "jid": 29})
        with pytest.raises(ValueError, match="already cancelled"):
            s.inject({"kind": "cancel", "t": now + 7, "jid": 29})
    b = open_session(8, "EASY", **CPU)
    with pytest.raises(ValueError, match="cluster events"):
        b.inject({"kind": "fail", "t": 1.0, "nodes": [0]})
    assert result_dict(ses.run()) == result_dict(ref.run())


@pytest.mark.parametrize("policy", ["FCFS", "EASY", "GreedyP */OPT=MIN",
                                    "GreedyPM */per/OPT=MIN/MINVT=600",
                                    "/stretch-per/OPT=MAX", "EASY+OPT=MIN",
                                    "Greedy */OPT=AVG", "MCB8 */OPT=MIN"])
def test_snapshots_equal_and_cross_between_packages(policy, tmp_path):
    events = (() if policy in ("FCFS", "EASY", "MCB8 */OPT=MIN")
              else ((800.0, "fail", (0, 1)), (5000.0, "join", (0, 1))))
    ses, ref = _pair(policy, n_jobs=50, n_nodes=16, seed=3, load=1.2,
                     events=events)
    ses.step(30)
    ref.step(30)
    mine, theirs = _same_snapshot(ses, ref)
    assert mine.payload["version"] == SNAPSHOT_VERSION == 3
    # the reference's snapshot, through a file, continues in the port
    path = str(tmp_path / "ref.json")
    theirs.save(path)
    port_cont = SimSession.restore(path, **CPU)
    assert port_cont.engine.alloc_backend is not None
    # the port's snapshot continues in the reference
    ref_cont = RefSession.restore(RefState.from_json_dict(
        json.loads(json.dumps(mine.to_json_dict()))))
    want = result_dict(ref.run())
    assert result_dict(port_cont.run()) == want
    assert result_dict(ref_cont.run()) == want
    assert result_dict(ses.run()) == want


def test_snapshot_round_trip_through_a_file(tmp_path):
    ses, _ = _pair("GreedyPM */per/OPT=MIN/MINVT=600", seed=6, load=1.3)
    ses.step(20)
    snap = ses.snapshot()
    path = snap.save(str(tmp_path / "s" / "snap.json"))
    back = SessionState.load(path)
    assert back.fingerprint == snap.fingerprint
    assert repr(back).startswith("SessionState(t=")
    assert back.n_jobs == 50 and back.policy == snap.policy
    with open(path) as f:
        data = json.load(f)
    data["vt"][0] = data["vt"][0] + 1.0
    with pytest.raises(ValueError, match="fingerprint mismatch"):
        SessionState.from_json_dict(data)
    with pytest.raises(ValueError, match="not a repro.session/v1"):
        SessionState({"schema": "other"})
    cont = SimSession.restore(back, **CPU)
    assert result_dict(cont.run()) == result_dict(ses.run())


def test_restore_refuses_bad_versions_and_missing_keys():
    ses, _ = _pair("EASY", n_jobs=20, n_nodes=8)
    ses.step(5)
    pl = dict(ses.snapshot().payload)
    with pytest.raises(ValueError, match="version 9 is not supported"):
        SimSession.restore(SessionState({**pl, "version": 9}), **CPU)
    short = dict(pl)
    del short["arrivals"]
    with pytest.raises(ValueError, match="missing required keys"):
        SimSession.restore(SessionState(short), **CPU)
    with pytest.raises(ValueError, match="pass policy="):
        SimSession.restore(SessionState({**pl, "policy": None}), **CPU)


@pytest.mark.parametrize("key", ["narrator", "autotune"])
def test_unported_state_keys_raise(key):
    """Both keys are ported now: a malformed payload under either raises,
    and a well-formed one restores."""
    ses, _ = _pair("GreedyP */OPT=MIN", n_jobs=20, n_nodes=8)
    if key == "narrator":
        ses.attach_narrator(parse_narrator("breakdown(mtbf=500)", seed=1))
    else:
        ses.attach_autotuner(AutoTuner("every=500;policies=EASY", seed=1))
    ses.step(5)
    good = ses.snapshot().payload
    bad = {**good, key: {"state": 1}}
    with pytest.raises(KeyError):
        SimSession.restore(SessionState(bad), **CPU)
    back = SimSession.restore(SessionState(good), **CPU)
    assert (back.narrator if key == "narrator" else back.autotuner) \
        is not None


def test_attach_narrator_and_autotuner_raise():
    """Attaching raises only where the reference refuses: cluster-event
    streams under a batch policy, a tuner over an ad-hoc policy, or a
    closed session."""
    ses = open_session(8, "EASY", **CPU)
    with pytest.raises(ValueError, match="does not handle cluster events"):
        ses.attach_narrator(parse_narrator("breakdown", seed=0))
    ses.attach_narrator(parse_narrator("noise", seed=0))
    assert ses.narrator is not None
    ses.engine.policy_ref = None
    with pytest.raises(ValueError, match="rebuildable reference"):
        ses.attach_autotuner(AutoTuner())
    ses.close()
    with pytest.raises(ValueError, match="closed"):
        ses.attach_narrator(parse_narrator("noise", seed=0))


def test_seed_policy_state_is_a_clear_error():
    ses, _ = _pair("EASY", n_jobs=20, n_nodes=8)
    ses.step(5)
    pl = {**ses.snapshot().payload,
          "policy_state": {"kind": "batch-seed", "queue": [], "free": [],
                           "running": [], "dirty": False}}
    with pytest.raises(ValueError, match="seed policy"):
        SimSession.restore(SessionState(pl), **CPU)
    # a fork onto the composed spelling does not read it
    assert SimSession.restore(SessionState(pl), policy="EASY", **CPU).run()


@pytest.mark.parametrize("policy", ["GreedyP */OPT=MIN", "EASY",
                                    "GreedyPM */per/OPT=MIN/MINVT=600"])
def test_fork_same_policy_is_an_exact_continuation(policy):
    events = (() if policy == "EASY"
              else ((600.0, "fail", (0, 1, 2, 3)),
                    (4000.0, "join", (0, 1, 2, 3))))
    ses, _ = _pair(policy, n_jobs=40, n_nodes=16, seed=2, load=1.2,
                   events=events)
    ses.step(20)
    fork = ses.fork(**CPU)
    assert result_dict(fork.run()) == result_dict(ses.run())


@pytest.mark.parametrize("alt", ["EASY", "FCFS", "EASY+OPT=MIN",
                                 "Greedy */per/OPT=MIN",
                                 "/stretch-per/OPT=AVG", "GreedyP */OPT=MIN"])
def test_fork_onto_another_policy_adopts_like_the_reference(alt):
    events = ((500.0, "fail", (0, 1)), (6000.0, "join", (0, 1)))
    ses, ref = _pair("GreedyPM */OPT=MIN", n_jobs=40, n_nodes=16, seed=3,
                     load=1.2, events=events)
    ses.step(18)
    ref.step(18)
    _zero_walls(ses, ref)
    mine = ses.fork(policy=alt, **CPU)
    theirs = ref.fork(policy=alt)
    assert mine.observe() == theirs.observe()
    _same_snapshot(mine, theirs)
    r = mine.run()
    assert result_dict(r) == result_dict(theirs.run())
    assert len(r.completions) == 40


def test_switch_policy_equals_reference():
    ses, ref = _pair("GreedyP */OPT=MIN", n_jobs=40, n_nodes=16, seed=9,
                     load=1.1)
    ses.step(15)
    ref.step(15)
    for s in (ses, ref):
        s.switch_policy("GreedyPM */per/OPT=MIN/MINVT=600")
    assert ses.policy_name == ref.policy_name
    assert result_dict(ses.run()) == result_dict(ref.run())


def test_partial_result_light_and_observe():
    ses, ref = _pair("GreedyP */OPT=MIN", n_jobs=40, n_nodes=8, seed=1)
    ses.step(25)
    ref.step(25)
    obs = ses.observe()
    part = ses.result()
    assert result_dict(part) == result_dict(ref.result())
    assert len(part.completions) == obs["n_completed"] < 40
    light = ses.result(light=True)
    assert light.completions == {} and light.stretches == {}
    for f in ("max_stretch", "mean_stretch", "makespan", "underutilization",
              "events", "final_time"):
        assert getattr(light, f) == getattr(part, f)
    assert ses.n_events == obs["events"] and not ses.exhausted
    assert ses.handles_cluster_events
    full = ses.run()
    assert ses.exhausted and not math.isinf(full.final_time)


def test_close_hooks_and_context_manager():
    calls = []
    ses = open_session(8, "GreedyP */OPT=MIN", **CPU)
    ses.add_close_hook(lambda s: calls.append("a"))

    def boom(s):
        calls.append("b")
        raise RuntimeError("hook")
    ses.add_close_hook(boom)
    ses.add_close_hook(lambda s: calls.append("c"))
    with pytest.raises(RuntimeError, match="hook"):
        ses.close()
    assert calls == ["a", "b", "c"] and ses.closed
    ses.close()                         # idempotent
    ses.add_close_hook(lambda s: calls.append("late"))
    assert calls[-1] == "late"
    for call in (lambda: ses.step(1), lambda: ses.snapshot(),
                 lambda: ses.submit([]), lambda: ses.compact(),
                 lambda: ses.inject({"kind": "period", "period": 5.0})):
        with pytest.raises(ValueError, match="closed"):
            call()
    assert ses.observe()["events"] == 0
    with open_session(8, "EASY", **CPU) as s2:
        assert not s2.closed
    assert s2.closed
    with pytest.raises(ValueError, match="closed"):
        s2.__enter__()


def test_open_session_params_and_policy_refs():
    ses = open_session(SimParams(n_nodes=12, penalty=60.0), "greedyp *",
                       **CPU)
    ref = ref_open(RefParams(n_nodes=12, penalty=60.0), "greedyp *")
    assert ses.engine.policy_ref == ref.engine.policy_ref == \
        "GreedyP */OPT=MIN"
    assert dataclasses.asdict(ses.engine.params) == \
        dataclasses.asdict(ref.engine.params)
    named = open_session(8, "EASY+OPT=MIN", stretch_tau=5.0, **CPU)
    assert named.engine.policy_ref == "EASY+OPT=MIN"
    assert named.engine.params.stretch_tau == 5.0
    with pytest.raises(ValueError, match="not both"):
        open_session(SimParams(), "EASY", params=SimParams(), **CPU)
    host = open_session(8, "GreedyP */OPT=MIN", alloc_backend="numpy")
    assert host.engine.alloc_backend is None
    with pytest.raises(ValueError, match="alloc_backend"):
        open_session(8, "EASY", alloc_backend="jax")
