"""Trace files, ``total_work``, the ``JobView`` and ``CSRIncidence``
members and the one-lane MIN solve of the port against the JAX package.

The seeded traces are the ``lublin``, ``hpc2n`` and ``tpu`` kinds, each
clairvoyant and with a ``proc_truth`` column from the ``ptime_noise``
scenario (``apply_scenario_trace``), built by each package from the same
spec.  A file either package writes (npz or JSON, ``repro.trace/v1``)
loads in the other with an equal fingerprint and equal columns, and the
rejections carry the reference's messages.  ``maxmin_yields_torch`` runs
on ``device="cpu"`` (the plain version of the ``maxmin_solve`` kernel) and
is held bit for bit to ``maxmin_yields_csr`` on the instances of
``tests/test_alloc_jax.py``.
"""
import json
import subprocess
import sys

import numpy as np
import pytest

from repro import api as ref_api
from repro.core.alloc_kernels import maxmin_yields_csr
from repro.sched import components as ref_components
from repro.sched.engine import Engine as RefEngine
from repro.sched.engine import SimParams as RefParams
from repro.sched.scenarios import apply_scenario_trace as ref_scenario
from repro.workloads.registry import WorkloadSpec as RefWorkload
from repro.workloads.registry import make_trace_ir as ref_trace_ir
from repro.workloads.trace import Trace as RefTrace

from conftest import result_dict
from test_alloc_jax import random_instance

from repro_torch import api
from repro_torch.core.alloc_kernels import CSRIncidence
from repro_torch.core.alloc_torch import csr_from_arrays, maxmin_yields_torch
from repro_torch.core.yield_alloc import allocate_incidence
from repro_torch.sched import components
from repro_torch.sched.engine import Engine, SimParams
from repro_torch.sched.scenarios import apply_scenario_trace
from repro_torch.workloads.registry import WorkloadSpec, make_trace_ir
from repro_torch.workloads.trace import COLUMNS, Trace

KINDS = ("lublin", "hpc2n", "tpu")
N_JOBS, N_NODES = 40, 32
TRACES = [(kind, truth) for kind in KINDS for truth in (False, True)]
TRACE_IDS = [f"{k}-{'truth' if t else 'clairvoyant'}" for k, t in TRACES]


def _traces(kind, truth, n_jobs=N_JOBS, n_nodes=N_NODES, seed=1):
    """(port trace, reference trace) of one seeded spec."""
    kw = dict(n_jobs=n_jobs, n_nodes=n_nodes, seed=seed)
    mine = make_trace_ir(WorkloadSpec(kind, **kw))
    ref = ref_trace_ir(RefWorkload(kind, **kw))
    if truth:
        mine, _ = apply_scenario_trace("ptime_noise", mine, n_nodes, seed=3)
        ref, _ = ref_scenario("ptime_noise", ref, n_nodes, seed=3)
        assert mine.proc_truth is not None
    return mine, ref


def _same(a, b):
    """Equal fingerprint, equal columns (the truth column included)."""
    assert a.fingerprint == b.fingerprint
    for name, dtype in COLUMNS:
        col = getattr(a, name)
        assert col.dtype == dtype and np.array_equal(col, getattr(b, name))
    assert (a.proc_truth is None) == (b.proc_truth is None)
    if a.proc_truth is not None:
        assert a.proc_truth.dtype == np.float64
        assert np.array_equal(a.proc_truth, b.proc_truth)


def _save(trace, fmt, path):
    return trace.save_npz(path) if fmt == "npz" else trace.save_json(path)


def _load(cls, fmt, path):
    return cls.load_npz(path) if fmt == "npz" else cls.load_json(path)


# --------------------------------------------------------------------------- #
# trace files                                                                  #
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("kind,truth", TRACES, ids=TRACE_IDS)
def test_trace_round_trips_in_the_port(kind, truth, tmp_path):
    tr, ref = _traces(kind, truth)
    _same(tr, ref)
    for fmt in ("npz", "json"):
        back = _load(Trace, fmt, _save(tr, fmt, str(tmp_path / f"t.{fmt}")))
        assert back == tr and back.to_specs() == tr.to_specs()
        _same(back, tr)


@pytest.mark.parametrize("fmt", ["npz", "json"])
@pytest.mark.parametrize("kind,truth", TRACES, ids=TRACE_IDS)
def test_reference_file_loads_in_the_port(kind, truth, fmt, tmp_path):
    tr, ref = _traces(kind, truth)
    back = _load(Trace, fmt, _save(ref, fmt, str(tmp_path / f"r.{fmt}")))
    _same(back, ref)
    _same(back, tr)


@pytest.mark.parametrize("fmt", ["npz", "json"])
@pytest.mark.parametrize("kind,truth", TRACES, ids=TRACE_IDS)
def test_port_file_loads_in_the_reference(kind, truth, fmt, tmp_path):
    tr, ref = _traces(kind, truth)
    back = _load(RefTrace, fmt, _save(tr, fmt, str(tmp_path / f"p.{fmt}")))
    _same(back, tr)
    _same(back, ref)


@pytest.mark.parametrize("kind,truth", TRACES, ids=TRACE_IDS)
def test_files_hold_what_the_reference_writes(kind, truth, tmp_path):
    """The JSON text is the reference's character for character; the npz
    holds the same arrays under the same keys with the same dtypes."""
    tr, ref = _traces(kind, truth)
    assert tr.to_json_dict() == ref.to_json_dict()
    assert json.dumps(tr.to_json_dict()) == json.dumps(ref.to_json_dict())
    with np.load(tr.save_npz(str(tmp_path / "p.npz"))) as mine, \
            np.load(ref.save_npz(str(tmp_path / "r.npz"))) as want:
        assert sorted(mine.files) == sorted(want.files)
        assert ("proc_truth" in want.files) == truth
        for key in want.files:
            assert mine[key].dtype == want[key].dtype
            assert mine[key].shape == want[key].shape
            assert np.array_equal(mine[key], want[key])


def _message(cls, fn):
    with pytest.raises(ValueError) as err:
        fn(cls)
    return str(err.value)


def test_foreign_npz_is_rejected_with_the_reference_message(tmp_path):
    path = str(tmp_path / "x.npz")
    np.savez(path, a=np.zeros(3))
    mine = _message(Trace, lambda c: c.load_npz(path))
    assert mine == _message(RefTrace, lambda c: c.load_npz(path))
    assert "repro.trace/v1" in mine and "schema: None" in mine
    other = str(tmp_path / "y.npz")
    np.savez(other, schema=np.array("repro.trace/v0"), a=np.zeros(3))
    mine = _message(Trace, lambda c: c.load_npz(other))
    assert mine == _message(RefTrace, lambda c: c.load_npz(other))
    assert "'repro.trace/v0'" in mine


def test_wrong_schema_and_corrupted_fingerprint_are_rejected(tmp_path):
    tr, _ = _traces("lublin", True)
    payload = tr.to_json_dict()
    wrong = dict(payload, schema="repro.trace/v0")
    mine = _message(Trace, lambda c: c.from_json_dict(wrong))
    assert mine == _message(RefTrace, lambda c: c.from_json_dict(wrong))
    assert mine == "not a repro.trace/v1 payload (schema: 'repro.trace/v0')"
    bad = json.loads(json.dumps(payload))
    bad["columns"]["proc_time"][0] *= 2.0
    path = tmp_path / "bad.json"
    path.write_text(json.dumps(bad))
    mine = _message(Trace, lambda c: c.load_json(str(path)))
    assert mine == _message(RefTrace, lambda c: c.load_json(str(path)))
    assert "fingerprint mismatch" in mine
    # without a fingerprint the payload loads as it stands, in both
    del bad["fingerprint"]
    _same(Trace.from_json_dict(bad), RefTrace.from_json_dict(bad))


@pytest.mark.parametrize("kind,truth", TRACES, ids=TRACE_IDS)
def test_total_work_is_bit_equal(kind, truth):
    tr, ref = _traces(kind, truth)
    assert isinstance(tr.total_work, float)
    assert tr.total_work == ref.total_work
    assert tr.select(tr.n_tasks >= 2).total_work == \
        ref.select(ref.n_tasks >= 2).total_work


@pytest.mark.parametrize("kind,truth", TRACES, ids=TRACE_IDS)
def test_simulating_a_loaded_trace_equals_the_original(kind, truth,
                                                       tmp_path):
    tr, ref = _traces(kind, truth)
    back = Trace.load_npz(tr.save_npz(str(tmp_path / "t.npz")))
    again = Trace.load_json(tr.save_json(str(tmp_path / "t.json")))
    policy = "GreedyPM */per/OPT=MIN/MINVT=600"
    want = result_dict(api.simulate(tr, policy, SimParams(n_nodes=N_NODES),
                                    device="cpu"))
    for t in (back, again):
        got = api.simulate(t, policy, SimParams(n_nodes=N_NODES),
                           device="cpu")
        assert result_dict(got) == want
    assert want == result_dict(ref_api.simulate(ref, policy,
                                                RefParams(n_nodes=N_NODES)))


# --------------------------------------------------------------------------- #
# JobView members, in a policy registered in both packages                    #
# --------------------------------------------------------------------------- #
def _reading_policy(comp, log):
    """GreedyP */OPT=MIN with a last component that logs what a policy
    reads through ``is_running`` and ``proc_truth``."""
    class Reader(comp.Component):
        def on_submit(self, js):
            log.append(("submit", js.spec.jid, js.is_running, js.proc_truth))

        def on_job_completed(self, js):
            log.append(("done", js.spec.jid, js.is_running, js.proc_truth))

    def make():
        base = comp.compose_from_spec("GreedyP */OPT=MIN")
        return comp.compose("jobview-reader", *base.components, Reader())
    return make


@pytest.fixture
def reader_logs():
    """The reading policy registered in both packages; unregistered after."""
    logs = ([], [])
    for comp, log in zip((components, ref_components), logs):
        comp.register_policy("jobview-reader", _reading_policy(comp, log))
    yield logs
    for comp in (components, ref_components):
        comp._POLICIES.pop("jobview-reader", None)


@pytest.mark.parametrize("kind", KINDS)
def test_jobview_members_read_by_a_registered_policy(kind, reader_logs):
    tr, ref = _traces(kind, True)
    mine, want = reader_logs
    got = api.simulate(tr, "jobview-reader", SimParams(n_nodes=N_NODES),
                       device="cpu")
    expected = ref_api.simulate(ref, "jobview-reader",
                                RefParams(n_nodes=N_NODES))
    assert result_dict(got) == result_dict(expected)
    assert mine == want and len(mine) > N_JOBS
    assert any(r[2] for r in mine)
    # the executed times are the truth column, not the estimate
    truth = dict(zip(tr.jid.tolist(), tr.proc_truth.tolist()))
    assert all(r[3] == truth[r[1]] for r in mine)


# --------------------------------------------------------------------------- #
# CSRIncidence.row_jobs                                                        #
# --------------------------------------------------------------------------- #
class _RowRecorder:
    """An ``alloc_backend`` that records every node's ``row_jobs`` of each
    incidence the engine hands it, then answers as the host path does."""

    def __init__(self, answer):
        self.rows, self.answer = [], answer

    def allocate(self, inc, cols, opt="MIN"):
        self.rows.append([inc.row_jobs(n).tolist()
                          for n in range(inc.n_nodes)])
        assert all(inc.row_jobs(n).dtype == inc.indices.dtype
                   for n in range(inc.n_nodes))
        return self.answer(inc, cols, opt=opt)


@pytest.mark.parametrize("kind", KINDS)
def test_row_jobs_equal_on_a_live_engines_incidence(kind):
    from repro.core.yield_alloc import allocate_incidence as ref_allocate
    tr, ref = _traces(kind, False, n_jobs=60, n_nodes=4)
    mine, want = _RowRecorder(allocate_incidence), _RowRecorder(ref_allocate)
    policy = "GreedyPM */OPT=MIN"
    got = Engine(tr, policy, SimParams(n_nodes=4), alloc_backend=mine).run()
    expected = RefEngine(ref, policy, RefParams(n_nodes=4),
                         alloc_backend=want).run()
    assert result_dict(got) == result_dict(expected)
    assert mine.rows == want.rows and len(mine.rows) > 10
    assert any(len(r) > 1 for rows in mine.rows for r in rows)
    assert all(r == sorted(r) for rows in mine.rows for r in rows)


# --------------------------------------------------------------------------- #
# the one-lane MIN solve                                                       #
# --------------------------------------------------------------------------- #
def _instances():
    """The instances ``test_maxmin_single_bit_equal`` draws, in its order."""
    rng = np.random.default_rng(7)
    return [random_instance(rng) for _ in range(30)]


INSTANCES = _instances()


@pytest.mark.parametrize("i", range(len(INSTANCES)))
def test_maxmin_yields_torch_is_bit_equal_to_maxmin_yields_csr(i):
    inc, active = INSTANCES[i]
    mine = csr_from_arrays(inc.n_nodes, inc.width, inc.indptr, inc.indices,
                           inc.data)
    assert isinstance(mine, CSRIncidence)
    got = maxmin_yields_torch(mine, active, device="cpu")
    want = maxmin_yields_csr(inc, active)
    assert got.dtype == np.float64 and got.shape == (inc.width,)
    assert np.array_equal(got, want)
    assert np.array_equal(got.view(np.int64), want.view(np.int64))


def test_maxmin_yields_torch_needs_the_card_unless_asked_for_the_cpu():
    import torch

    from repro_torch.core import alloc_torch
    from repro_torch.device import BackendFault
    assert "maxmin_yields_torch" in alloc_torch.__all__
    inc, active = INSTANCES[0]
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(BackendFault, match="device='cpu'"):
        maxmin_yields_torch(inc, active)


# --------------------------------------------------------------------------- #
# the serve client stays a plain socket program                                #
# --------------------------------------------------------------------------- #
def test_serve_client_loads_no_torch_and_protocol_names_resolve_lazily():
    probe = ("import sys, repro_torch.serve.client, "
             "repro_torch.serve.protocol as p; "
             "print('torch' in sys.modules); "
             "from repro_torch.sched import session; "
             "from repro_torch.core import job; "
             "print(p.SimSession is session.SimSession, "
             "p.open_session is session.open_session, "
             "p.JobSpec is job.JobSpec)")
    out = subprocess.run([sys.executable, "-c", probe], capture_output=True,
                         text=True, timeout=120, check=True)
    assert out.stdout.split() == ["False", "True", "True", "True"]
