"""The chaos narrator in the port (``repro_torch.sched.narrator`` and the
session's narrator hooks) against the JAX package's, on the CPU.

Sessions under the same narrator seed must equal the reference's session
in every ``SimResult`` field (per-job dicts included) — on the host numpy
path and on ``device="cpu"`` — across step boundaries, across a mid-chaos
snapshot restored in the same or a fresh process, and across the packages
(snapshots with a ``narrator`` key cross both ways with equal
fingerprints).
"""
import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest

from conftest import result_dict
from repro.sched.narrator import list_streams as ref_list_streams
from repro.sched.narrator import narrator_docs as ref_narrator_docs
from repro.sched.narrator import parse_narrator as ref_parse_narrator
from repro.sched.session import SimSession as RefSession
from repro.sched.session import open_session as ref_open_session
from repro.workloads.registry import WorkloadSpec as RefWorkload
from repro.workloads.registry import make_trace_ir as ref_trace

from repro_torch.sched.narrator import (Narrator, list_streams,
                                        narrator_docs, parse_narrator)
from repro_torch.sched.session import SessionState, SimSession, open_session
from repro_torch.workloads.registry import WorkloadSpec, make_trace_ir

ROOT = pathlib.Path(__file__).resolve().parents[1]
NUMPY = dict(alloc_backend="numpy")
CPU = dict(device="cpu")
W = dict(kind="lublin", n_jobs=60, n_nodes=16, seed=0, load=0.9)
CHAOS = ("breakdown(mtbf=3e2,repair=2e2)+cancel(rate=2e-3)"
         "+malleable(rate=2e-3)+noise(sigma=0.3)")


def _session(spec=CHAOS, seed=7, policy="GreedyP */OPT=MIN", shift=None,
             **where):
    ses = open_session(W["n_nodes"], policy, **where)
    ses.attach_narrator(parse_narrator(spec, seed=seed))
    ses.submit(make_trace_ir(WorkloadSpec(**W)), shift=shift)
    return ses


def _ref_session(spec=CHAOS, seed=7, policy="GreedyP */OPT=MIN", shift=None):
    ses = ref_open_session(W["n_nodes"], policy)
    ses.attach_narrator(ref_parse_narrator(spec, seed=seed))
    ses.submit(ref_trace(RefWorkload(**W)), shift=shift)
    return ses


def test_narrator_grammar_and_registry():
    assert list_streams() == ref_list_streams()
    assert set(narrator_docs()) == set(ref_narrator_docs())
    assert all(narrator_docs().values())
    nar = parse_narrator("breakdown(mtbf=2e4,repair=2e3)+noise", seed=3)
    assert len(nar.streams) == 2 and nar.needs_cluster_events()
    assert repr(nar) == repr(ref_parse_narrator(
        "breakdown(mtbf=2e4,repair=2e3)+noise", seed=3))
    assert not parse_narrator("noise", seed=0).needs_cluster_events()
    with pytest.raises(ValueError, match="unknown narrator stream"):
        parse_narrator("gremlins")
    with pytest.raises(ValueError, match="key=value"):
        parse_narrator("breakdown(2e4)")
    with pytest.raises(ValueError):
        parse_narrator("cancel(rate=-1)")
    with pytest.raises(ValueError, match="at least one stream"):
        Narrator([])


@pytest.mark.parametrize("where", [NUMPY, CPU], ids=["numpy", "cpu"])
def test_same_seed_same_run_equal_to_reference(where):
    ref = _ref_session().run()
    a = _session(**where).run()
    b = _session(**where).run()
    assert result_dict(a) == result_dict(b) == result_dict(ref)
    assert a.n_cancelled >= 1                   # the chaos happened
    other = _session(seed=8, **NUMPY).run()
    assert result_dict(other) != result_dict(a)


def test_injected_events_equal_reference():
    ses, ref = _session(**NUMPY), _ref_session()
    ses.run()
    ref.run()
    mine = [(e.time, e.kind, e.nodes, e.jids, e.value) for e in ses._cev]
    theirs = [(e.time, e.kind, e.nodes, e.jids, e.value) for e in ref._cev]
    assert mine == theirs
    assert {e[1] for e in mine} == {"fail", "join", "cancel", "resize"}
    st, rst = ses.engine.state, ref.engine.state
    assert np.array_equal(st.proc_truth, rst.proc_truth)


def test_skipped_firings_keep_the_draw_order():
    """Streams fire before any job arrives (cancel and resize find nothing
    to act on and skip): each still draws its victim, so the runs stay
    equal after the skips."""
    spec = "cancel(rate=2e-3)+malleable(rate=2e-3)+breakdown(mtbf=1e3)"
    ses = _session(spec, shift=3000.0, **NUMPY)
    ref = _ref_session(spec, shift=3000.0)
    assert result_dict(ses.run()) == result_dict(ref.run())


def test_identity_across_step_boundaries():
    ref = _session(**NUMPY).run()
    ses = _session(**CPU)
    for t in np.linspace(0.0, 4.0e3, 17):
        ses.step_until(float(t))
    assert result_dict(ses.run()) == result_dict(ref)


def test_snapshot_restore_mid_chaos(tmp_path):
    ref = _session(**NUMPY).run()
    ses = _session(**NUMPY)
    ses.step_until(800.0)
    path = ses.snapshot().save(str(tmp_path / "chaos.json"))
    restored = SimSession.restore(path, **CPU)
    assert restored.narrator is not None
    assert result_dict(restored.run()) == result_dict(ref)


def test_snapshot_restore_in_a_fresh_process(tmp_path):
    ref = _session(**NUMPY).run()
    ses = _session(**NUMPY)
    ses.step_until(800.0)
    path = ses.snapshot().save(str(tmp_path / "chaos.json"))
    prog = ("import dataclasses, json, sys\n"
            "from repro_torch.sched.session import SimSession\n"
            "r = SimSession.restore(sys.argv[1], alloc_backend='numpy').run()\n"
            "d = dataclasses.asdict(r)\n"
            "d.pop('sim_wall_s')\n"
            "print(json.dumps(d))\n")
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    out = subprocess.run([sys.executable, "-c", prog, path],
                         capture_output=True, text=True, check=True,
                         env=env, timeout=120)
    assert json.loads(out.stdout) == json.loads(json.dumps(result_dict(ref)))


@pytest.mark.parametrize("direction", ["port-to-reference",
                                       "reference-to-port"])
def test_snapshots_with_a_narrator_cross_both_ways(direction):
    ses, ref = _session(**NUMPY), _ref_session()
    ses.step_until(700.0)
    ref.step_until(700.0)
    ses._wall = ref._wall = 0.0         # a measurement, not state
    mine, theirs = ses.snapshot(), ref.snapshot()
    assert "narrator" in mine.payload
    assert mine.fingerprint == theirs.fingerprint
    whole = result_dict(_ref_session().run())
    if direction == "port-to-reference":
        got = RefSession.restore(mine.to_json_dict()).run()
    else:
        got = SimSession.restore(SessionState.from_json_dict(
            theirs.to_json_dict()), **CPU).run()
    assert result_dict(got) == whole


def test_batch_policies_take_noise_only():
    with pytest.raises(ValueError, match="does not handle cluster events"):
        _session(policy="EASY", **NUMPY)
    a = _session("noise(sigma=0.5)", policy="EASY", **NUMPY).run()
    b = _ref_session("noise(sigma=0.5)", policy="EASY").run()
    assert result_dict(a) == result_dict(b)
    # a fork onto a batch baseline drops the cluster streams, keeps noise
    ses = _session(**NUMPY)
    ses.step_until(600.0)
    fork = ses.fork("EASY", **NUMPY)
    assert fork.narrator is None
    with pytest.raises(ValueError, match="narrator injects them"):
        ses.switch_policy("EASY")
    noisy = _session("noise(sigma=0.5)", **NUMPY)
    noisy.step_until(600.0)
    assert noisy.fork("FCFS", **NUMPY).narrator is not None
