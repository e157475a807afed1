"""The online autotuner in the port (``repro_torch.tune`` and the session's
autotuner hooks) against the JAX package's, on the CPU.

The reference's own demo (``benchmarks/tune_bench.py``, ``BENCH_tune.json``:
Lublin 150 jobs on 32 nodes, seed 7, load 1.1, nodes 0-7 failing at
2,050 s and joining at 7,000 s) must swap once, at 6,000 s, and end at max
stretch 301.598467 with the reference's decision log — its races in
lockstep on ``device="cpu"`` and on the host numpy path.  Races, tuner
state in snapshots and the spec grammars are held to the reference's too.
"""
import dataclasses
import math

import pytest

from conftest import result_dict
from repro import api as ref_api
from repro.sched.session import SessionState as RefState
from repro.sched.session import SimSession as RefSession
from repro.tune import parse_objective as ref_parse_objective
from repro.tune import parse_tune as ref_parse_tune
from repro.tune import race as ref_race
from repro.tune import Variant as RefVariant

from repro_torch import api
from repro_torch.sched.session import SessionState, SimSession
from repro_torch.tune import (AutoTuner, TuneConfig, Variant, list_objectives,
                              parse_objective, parse_tune, race)

CPU = dict(device="cpu")
NUMPY = dict(alloc_backend="numpy")
PORTFOLIO = ["GreedyP */OPT=MIN", "GreedyPM */per/OPT=MIN/MINVT=600"]
SPEC = ("every=1500;horizon=4000;rungs=2;margin=0.01;dwell=0;"
        "policies=" + "|".join(PORTFOLIO))


def _drive(facade, ses, stop=None):
    ses.submit(facade.parse_workload("lublin", n_jobs=150, n_nodes=32,
                                     seed=7, load=1.1))
    ses.inject({"kind": "fail", "t": 2050.0, "nodes": list(range(8))})
    ses.inject({"kind": "join", "t": 7000.0, "nodes": list(range(8))})
    if stop is None:
        ses.run_to_exhaustion()
    else:
        ses.step_until(stop)


def _tuned(facade=api, stop=None, **where):
    ses = facade.open_session(32, PORTFOLIO[0], **where)
    tuner = facade.autotune(ses, SPEC, seed=3)
    _drive(facade, ses, stop)
    return ses, tuner


@pytest.fixture(scope="module")
def reference_demo():
    ses, tuner = _tuned(ref_api)
    return ses.result(), tuner.decisions


def _check_demo(ses, tuner, reference_demo):
    ref_result, ref_decisions = reference_demo
    r = ses.result()
    assert round(r.max_stretch, 6) == 301.598467
    swaps = [d for d in tuner.decisions if d["swapped"]]
    assert [d["t"] for d in swaps] == [6000.0]
    assert ses.policy_name == PORTFOLIO[1]
    assert tuner.decisions == ref_decisions
    assert result_dict(r) == result_dict(ref_result)


@pytest.mark.parametrize("where", [NUMPY, CPU], ids=["numpy", "cpu"])
def test_reference_demo_swaps_once_and_equals_reference(where,
                                                        reference_demo):
    ses, tuner = _tuned(**where)
    _check_demo(ses, tuner, reference_demo)
    assert len(tuner.decisions) == 6


def test_tuner_races_where_the_session_allocates():
    cpu = api.open_session(8, "GreedyP */OPT=MIN", **CPU)
    host = api.open_session(8, "GreedyP */OPT=MIN", **NUMPY)
    tuner = AutoTuner(SPEC)
    assert tuner._race_target(cpu)["backend"] == "torch"
    assert str(tuner._race_target(cpu)["device"]) == "cpu"
    assert tuner._race_target(host) == {"backend": "numpy"}
    for backend in (None, "jax", "pallas"):
        tun = AutoTuner(dataclasses.replace(tuner.config, backend=backend))
        assert tun._race_target(cpu)["backend"] == "torch"
    pinned = AutoTuner(dataclasses.replace(tuner.config, backend="numpy"))
    assert pinned._race_target(cpu) == {"backend": "numpy"}
    # an unknown backend is a broken race: logged, never a crash
    ses = api.open_session(32, PORTFOLIO[0], **NUMPY)
    bogus = AutoTuner(dataclasses.replace(tuner.config, backend="bogus"))
    ses.attach_autotuner(bogus)
    _drive(api, ses, stop=1600.0)
    assert bogus.decisions[0]["reason"] == "race-error"
    assert "bogus" in bogus.decisions[0]["error"]


@pytest.mark.parametrize("spec", [
    SPEC, "every=5000", "every=3000;horizon=1000;rungs=3;objective=0.7*"
    "max_stretch+0.3*mean_stretch;margin=0.1;dwell=100;periods=600,1200;"
    "timeout=30;retries=1;backend=numpy"])
def test_parse_tune_equals_reference(spec):
    mine, theirs = parse_tune(spec), ref_parse_tune(spec)
    assert dataclasses.asdict(mine) == dataclasses.asdict(theirs)
    assert (mine.base_horizon, mine.min_dwell) == \
        (theirs.base_horizon, theirs.min_dwell)


@pytest.mark.parametrize("bad", ["every", "every=0", "rungs=0", "margin=1",
                                 "dwell=-1", "objective=speed", "nope=1",
                                 "horizon=-5"])
def test_parse_tune_rejects(bad):
    with pytest.raises(ValueError):
        parse_tune(bad)


def test_parse_objective_equals_reference():
    assert list_objectives() == sorted(
        ["max_stretch", "mean_stretch", "makespan", "underutilization",
         "migration"])
    rec = {"max_stretch": 4.0, "mean_stretch": 2.0, "mig_per_job": 3.0}
    for spec in list_objectives() + ["0.7*max_stretch+0.3*mean_stretch",
                                     "mean_stretch+2*mig_per_job"]:
        mine, theirs = parse_objective(spec), ref_parse_objective(spec)
        assert mine.terms == theirs.terms
        assert str(mine.score(rec)) == str(theirs.score(rec))
    assert parse_objective("max_stretch").prunable_by_max_stretch
    assert math.isinf(parse_objective("max_stretch").score(
        {"quarantined": True}))
    for bad in ("speed", "2*speed", "*max_stretch", ""):
        with pytest.raises(ValueError):
            parse_objective(bad)


def _race_snapshot():
    ses = api.open_session(32, PORTFOLIO[0], **NUMPY)
    _drive(api, ses, stop=3000.0)
    ses._wall = 0.0                     # a measurement, not state
    return ses.snapshot()


@pytest.mark.parametrize("where", [dict(backend="numpy"), CPU],
                         ids=["numpy", "cpu"])
def test_race_equals_reference(where):
    snap = _race_snapshot()
    variants = [Variant("GreedyPM */OPT=MIN"), Variant(PORTFOLIO[1]),
                Variant(PORTFOLIO[0], 1200.0), Variant("NoSuchPolicy")]
    kw = dict(base_horizon=1500.0, rungs=2, branch_seed=5)
    mine = race(snap, variants, Variant(PORTFOLIO[0]), **kw, **where)
    theirs = ref_race(RefState.from_json_dict(snap.to_json_dict()),
                      [RefVariant(v.policy, v.period) for v in variants],
                      RefVariant(PORTFOLIO[0]), **kw)
    assert mine.rungs == theirs.rungs
    assert dataclasses.asdict(mine.winner) == dataclasses.asdict(
        theirs.winner)
    assert (mine.winner_score, mine.incumbent_score) == \
        (theirs.winner_score, theirs.incumbent_score)
    assert mine.rungs[0]["scores"][-1] == math.inf   # quarantined: loses
    with pytest.raises(ValueError):
        race(snap, variants, Variant(PORTFOLIO[0]), base_horizon=0.0,
             **where)


def test_tuner_state_through_a_snapshot(tmp_path, reference_demo):
    """A tuned session snapshotted mid-run fingerprints as the reference's,
    and restored in either package re-fires, re-decides and ends as the
    uninterrupted run."""
    ses, tuner = _tuned(stop=4000.0, **NUMPY)
    ref, _ = _tuned(ref_api, stop=4000.0)
    ses._wall = ref._wall = 0.0         # a measurement, not state
    snap, ref_snap = ses.snapshot(), ref.snapshot()
    assert "autotune" in snap.payload
    assert snap.fingerprint == ref_snap.fingerprint
    path = snap.save(str(tmp_path / "tuned.json"))
    back = SimSession.restore(SessionState.load(path), **NUMPY)
    assert isinstance(back.autotuner, AutoTuner)
    assert back.autotuner.decisions == tuner.decisions
    back.run_to_exhaustion()
    _check_demo(back, back.autotuner, reference_demo)
    there = RefSession.restore(path)
    there.run_to_exhaustion()
    assert there.autotuner.decisions == reference_demo[1]
    # a policy-switching fork is a branch: it never runs the tuner
    assert ses.fork("EASY", **NUMPY).autotuner is None


def test_tuner_config_round_trips_and_refuses_ad_hoc_policies():
    tun = AutoTuner(TuneConfig(every=100.0, policies=("EASY",),
                               periods=(600.0,)), seed=4)
    again = AutoTuner.from_state(tun.state())
    assert again.state() == tun.state()
    ses = api.open_session(8, "GreedyP */OPT=MIN", **NUMPY)
    ses.engine.policy_ref = None        # an ad-hoc Policy instance
    with pytest.raises(ValueError, match="rebuildable reference"):
        api.autotune(ses, "every=100")
