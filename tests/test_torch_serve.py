"""The port's session server (``repro_torch.serve``) against the JAX
package's, on the CPU.

The port's server runs with ``device="cpu"`` (every session's
``TorchAllocBackend`` on the kernels' plain versions); the reference runs
its host numpy path.  Every comparison is bit-exact:

* admission: the credit arithmetic and the weighted-DRF pick order under a
  fake clock, step for step against the reference's;
* the registry: seq discipline, eviction and rehydration, crash recovery
  from a journal and from a snapshot plus a journal suffix, each result
  against the port's host numpy session run of the same ops; evicted and
  closed sessions drop their backends;
* the live server: a multi-tenant script gives equal response payloads
  from the port's server and the reference's (wall-clock fields aside),
  driven by either package's client; concurrent tenants against serial
  host runs;
* stores crossing between the packages both ways;
* ``kill -9`` of a ``python -m repro_torch serve --device cpu`` process,
  restarted and re-driven: the result equals the uninterrupted host run;
* a fault of the allocation backend's device work stops the server
  (live, and while a journal replays) instead of coming back as an op
  error, and a restart without the fault recovers the session exactly;
  a failure of the backend's host work is an op error, as in the
  reference.
"""
import os
import signal
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch

from conftest import result_dict

from repro.serve.admission import CreditParams as RefCredit
from repro.serve.admission import FairQueue as RefQueue
from repro.serve.admission import TenantState as RefTenant
from repro.serve.client import Client as RefClient
from repro.serve.client import ServeError as RefServeError
from repro.serve.registry import SessionRegistry as RefRegistry
from repro.serve.registry import SessionStore as RefStore
from repro.serve.server import ServeConfig as RefConfig
from repro.serve.server import ServerThread as RefServerThread

from repro_torch import api
from repro_torch.core import alloc_torch
from repro_torch.core.alloc_torch import TorchBatchedAllocator
from repro_torch.device import BackendFault
from repro_torch.serve import (Client, CreditParams, FairQueue,
                               ProtocolError, ServeConfig, ServeError,
                               ServerThread, SessionRegistry, SessionStore,
                               TenantState)
from repro_torch.serve.protocol import (E_ADMISSION, E_OP_ERROR,
                                        E_OVER_BUDGET, E_SEQ_GAP,
                                        E_UNKNOWN_SESSION)

NODES = 16
POLICY = "GreedyP */OPT=MIN"
OPEN = {"policy": POLICY, "nodes": NODES}
SUBMIT = {"workload": "lublin", "jobs": 30, "seed": 0, "nodes": NODES}
CPU = dict(device="cpu")


class FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t

    def advance(self, dt):
        self.t += dt


def host_result(policy=POLICY, jobs=30, seed=0, nodes=NODES, until=None,
                inject=None):
    """The uninterrupted run of the same ops on the port's host numpy
    path."""
    ses = api.open_session(nodes, policy, alloc_backend="numpy")
    ses.submit(api.parse_workload("lublin", n_jobs=jobs, n_nodes=nodes,
                                  seed=seed))
    if until is not None:
        ses.step_until(until)
    if inject is not None:
        ses.inject(inject)
    ses.run_to_exhaustion()
    return result_dict(ses.result())


def norm_result(resp):
    """A ``result`` payload as :func:`conftest.result_dict` has it (JSON
    round-trips dict keys to str)."""
    d = {k: v for k, v in resp.items()
         if k not in ("id", "ok", "partial", "sim_wall_s", "kind",
                      "next_seq")}
    for k in ("completions", "stretches"):
        d[k] = {int(a): b for a, b in d[k].items()}
    return d


def registry_on(tmp_path, **kw):
    store = SessionStore(str(tmp_path / "store"))
    return SessionRegistry(store, device="cpu", **kw), store


# --------------------------------------------------------------------------- #
# admission, step for step against the reference                               #
# --------------------------------------------------------------------------- #
def _credit_steps(seed):
    rng = np.random.default_rng(seed)
    for _ in range(60):
        kind = rng.choice(["charge", "violation", "advance"])
        if kind == "charge":
            yield ("charge", dict(ops=float(rng.integers(0, 30)),
                                  events=float(rng.uniform(0, 5000)),
                                  wall=float(rng.exponential(0.05))))
        elif kind == "violation":
            yield ("violation", float(rng.uniform(0, 4)))
        else:
            yield ("advance", float(rng.exponential(8.0)))


@pytest.mark.parametrize("seed", range(4))
def test_credit_arithmetic_equals_reference(seed):
    params = dict(budget=200.0, window_s=12.0, target_latency_s=0.04,
                  latency_window=16)
    clock, r_clock = FakeClock(), FakeClock()
    t = TenantState("acme", CreditParams(**params), clock)
    r = RefTenant("acme", RefCredit(**params), r_clock)
    for kind, arg in _credit_steps(seed):
        if kind == "charge":
            t.charge(**arg)
            r.charge(**arg)
        elif kind == "violation":
            t.violation(arg)
            r.violation(arg)
        else:
            clock.advance(arg)
            r_clock.advance(arg)
        assert t.snapshot() == r.snapshot()
        assert t.usage == r.usage and t.cost_used == r.cost_used


@pytest.mark.parametrize("seed", range(4))
def test_fair_queue_pick_order_and_refusals_equal_reference(seed):
    rng = np.random.default_rng(100 + seed)
    params = dict(budget=60.0, window_s=20.0, max_pending=5)
    clock, r_clock = FakeClock(), FakeClock()
    q = FairQueue(CreditParams(**params), clock=clock)
    r = RefQueue(RefCredit(**params), clock=r_clock)
    names = ["acme", "umbrella", "globex", "initech", "hooli"]
    picks, r_picks = [], []
    for step in range(300):
        name = str(rng.choice(names))
        roll = rng.random()
        if roll < 0.5:
            outs = []
            for queue in (q, r):
                try:
                    queue.admit(name, step)
                    outs.append("ok")
                except ValueError as exc:       # ProtocolError of each
                    outs.append(exc.code)
            assert outs[0] == outs[1]
        elif roll < 0.8:
            for queue, out in ((q, picks), (r, r_picks)):
                got = queue.pick()
                if got is None:
                    out.append(None)
                else:
                    tenant, item = got
                    tenant.charge(ops=1.0, events=float(item % 7) * 100.0,
                                  wall=0.002 * (item % 5))
                    if item % 11 == 0:
                        tenant.violation()
                    out.append((tenant.name, item))
        else:
            dt = float(rng.exponential(3.0))
            clock.advance(dt)
            r_clock.advance(dt)
        assert q.backlog() == r.backlog()
    assert picks == r_picks and any(p is not None for p in picks)
    assert q.stats() == r.stats()


def test_admission_refusals_carry_the_reference_codes():
    q = FairQueue(CreditParams(max_pending=1, budget=5.0), clock=FakeClock())
    q.admit("t", "a")
    with pytest.raises(ProtocolError) as ei:
        q.admit("t", "b")
    assert ei.value.code == E_ADMISSION
    q.tenant("u").charge(ops=10.0)
    with pytest.raises(ProtocolError) as ei:
        q.admit("u", "c")
    assert ei.value.code == E_OVER_BUDGET


# --------------------------------------------------------------------------- #
# the registry                                                                 #
# --------------------------------------------------------------------------- #
def test_registry_seq_discipline(tmp_path):
    reg, _ = registry_on(tmp_path)
    reg.apply_mutating("t", "s0", "open", OPEN, seq=0)
    reg.apply_mutating("t", "s0", "submit", SUBMIT, seq=1)
    dup = reg.apply_mutating("t", "s0", "submit", SUBMIT, seq=1)
    assert dup == {"dup": True, "seq": 1, "applied_seq": 2}
    with pytest.raises(ProtocolError) as ei:
        reg.apply_mutating("t", "s0", "step", {"n": 1}, seq=7)
    assert ei.value.code == E_SEQ_GAP
    with pytest.raises(ProtocolError) as ei:
        reg.apply_mutating("t", "nope", "step", {"n": 1}, seq=0)
    assert ei.value.code == E_UNKNOWN_SESSION
    # the session allocates on the registry's device
    backend = reg.entries[("t", "s0")].session.engine.alloc_backend
    assert isinstance(backend, TorchBatchedAllocator)
    assert str(backend.device) == "cpu"


def test_evict_rehydrate_equals_host_and_releases_the_backend(tmp_path):
    reg, _ = registry_on(tmp_path)
    reg.apply_mutating("t", "s0", "open", OPEN, seq=0)
    reg.apply_mutating("t", "s0", "submit", SUBMIT, seq=1)
    reg.apply_mutating("t", "s0", "step_until", {"t": 4000.0}, seq=2)
    ses = reg.entries[("t", "s0")].session
    reg.evict("t", "s0")
    assert ses.closed and ses.engine.alloc_backend is None
    reg.apply_mutating("t", "s0", "run", {}, seq=3)
    assert reg.n_rehydrations == 1
    live = reg.live_session("t", "s0")
    assert str(live.engine.alloc_backend.device) == "cpu"
    assert result_dict(live.result()) == host_result(until=4000.0)
    reg.apply_mutating("t", "s0", "close", {}, seq=4)
    assert live.closed and live.engine.alloc_backend is None


def test_live_sessions_and_backends_stay_at_max_live(tmp_path):
    clock = FakeClock()
    reg, _ = registry_on(tmp_path, max_live=2, clock=clock)
    held = []
    for i in range(6):
        clock.advance(1.0)
        reg.apply_mutating("t", f"s{i}", "open", OPEN, seq=0)
        held.append(reg.entries[("t", f"s{i}")].session)
        reg.evict_over_cap()
        assert reg.n_live <= 2
    attached = [s for s in held if s.engine.alloc_backend is not None]
    assert len(attached) == 2 and reg.n_evictions == 4


def test_recovery_from_snapshot_plus_journal_suffix(tmp_path):
    reg, store = registry_on(tmp_path)
    reg.apply_mutating("t", "s0", "open", OPEN, seq=0)
    reg.apply_mutating("t", "s0", "submit", SUBMIT, seq=1)
    reg.checkpoint("t", "s0")
    reg.apply_mutating("t", "s0", "step_until", {"t": 4000.0}, seq=2)
    inject = {"kind": "fail", "t": 4100.0, "nodes": [0, 1]}
    reg.apply_mutating("t", "s0", "inject", dict(inject), seq=3)
    del reg                                     # a crash: nothing persisted
    reg2 = SessionRegistry(SessionStore(store.root), device="cpu")
    assert reg2.recover() == 1
    assert reg2.apply_mutating("t", "s0", "inject", dict(inject),
                               seq=3)["dup"]
    reg2.apply_mutating("t", "s0", "run", {}, seq=4)
    got = result_dict(reg2.live_session("t", "s0").result())
    assert got == host_result(until=4000.0, inject=inject)


def test_torn_journal_tail_is_dropped(tmp_path):
    reg, store = registry_on(tmp_path)
    reg.apply_mutating("t", "s0", "open", OPEN, seq=0)
    reg.apply_mutating("t", "s0", "submit", SUBMIT, seq=1)
    del reg
    with open(store.journal_path("t", "s0"), "a") as f:
        f.write('{"seq": 2, "op": "step_unt')
    reg2 = SessionRegistry(SessionStore(store.root), device="cpu")
    assert reg2.recover() == 1 and reg2.entries[("t", "s0")].seq == 2
    reg2.apply_mutating("t", "s0", "run", {}, seq=2)
    assert result_dict(reg2.live_session("t", "s0").result()) == host_result()


# --------------------------------------------------------------------------- #
# the live server against the reference's                                      #
# --------------------------------------------------------------------------- #
_INLINE = [{"jid": j, "release": 40.0 * j, "proc_time": 600.0 + 37.0 * j,
            "n_tasks": 1 + j % 4, "cpu_need": [0.25, 0.5, 1.0][j % 3],
            "mem_req": 0.1} for j in range(12)]


def _norm(op, resp):
    d = {k: v for k, v in resp.items()
         if k != "id" and "wall" not in k and k != "uptime_s"}
    if op == "snapshot":
        d.pop("path", None)
        d.pop("fingerprint", None)              # covers the loop's clock
    if op == "stats":
        d = {k: d[k] for k in ("ok", "registry", "backlog", "recovered")}
    if op == "hello":
        d.pop("credit", None)
    return d


def _script(client_cls, error_cls, port):
    """A sequential two-tenant script over every op; the normalized
    responses in order."""
    acme = client_cls("127.0.0.1", port, tenant="acme")
    umb = client_cls("127.0.0.1", port, tenant="umbrella")
    out = []

    def call(c, op, session=None, **kw):
        try:
            resp = c.call(op, session, **kw)
        except error_cls as exc:
            resp = {"error_code": exc.code, "error": str(exc)}
        out.append(_norm(op, resp))

    call(acme, "hello")
    call(acme, "open", "s0", policy=POLICY, nodes=NODES)
    call(umb, "open", "u0", policy="Greedy */OPT=AVG", nodes=NODES,
         period=1200.0)
    call(acme, "open", "s1", policy="EASY", nodes=NODES)
    call(acme, "submit", "s0", workload="lublin", jobs=30, seed=0,
         nodes=NODES)
    call(umb, "submit", "u0", workload="lublin", jobs=30, seed=1,
         nodes=NODES, load=0.9)
    call(acme, "submit", "s1", specs=_INLINE)
    call(acme, "step_until", "s0", t=2000.0)
    call(umb, "step", "u0", n=7)
    call(acme, "inject", "s0", kind="fail", t=2500.0, nodes=[0, 1])
    call(acme, "observe", "s0")
    call(acme, "snapshot", "s0")
    call(umb, "period", "u0", period=900.0)
    call(acme, "step_until", "s1", t=1000.0)
    call(acme, "step", "ghost", n=1)                    # unknown session
    call(acme, "step", "s0", n=1, seq=99)               # seq gap
    call(acme, "frobnicate", "s0")                      # unknown op
    call(acme, "open", "s0", policy=POLICY, nodes=NODES, seq=0)   # dup
    call(acme, "tune", "s0")                            # no autotuner
    call(acme, "submit", "s0", workload="nosuchkind", jobs=3)    # op error
    call(acme, "sessions")
    call(acme, "run", "s0")
    call(acme, "result", "s0")
    call(umb, "run", "u0")
    call(umb, "result", "u0")
    call(acme, "run", "s1")
    call(acme, "close", "s1")
    call(acme, "step", "s1", n=1)                       # closed
    call(acme, "result", "s1")
    call(acme, "delete", "s1")
    call(acme, "stats")
    acme.close()
    umb.close()
    return out


@pytest.mark.parametrize("client", ["reference", "port"])
def test_multi_tenant_script_payloads_equal_reference_server(tmp_path,
                                                              client):
    client_cls, error_cls = ((RefClient, RefServeError)
                             if client == "reference"
                             else (Client, ServeError))
    with ServerThread(ServeConfig(store=str(tmp_path / "port"), max_live=2,
                                  **CPU)) as srv:
        got = _script(client_cls, error_cls, srv.port)
    with RefServerThread(RefConfig(store=str(tmp_path / "ref"),
                                   max_live=2)) as srv:
        ref = _script(client_cls, error_cls, srv.port)
    assert len(got) == len(ref)
    for i, (a, b) in enumerate(zip(got, ref)):
        assert a == b, f"response {i} differs"
    codes = [r.get("error_code") for r in got]
    assert codes.count(None) < len(codes) - 5           # errors exercised
    assert got[-1]["registry"]["evictions"] > 0


def _tenant(port, tenant, plan, out, errs):
    try:
        with Client("127.0.0.1", port, tenant=tenant) as c:
            for name, seed in plan:
                c.open(name, POLICY, nodes=NODES)
                c.submit(name, workload="lublin", jobs=30, seed=seed,
                         nodes=NODES)
            for t in (2000.0, 6000.0):
                for name, _ in plan:
                    c.step_until(name, t)
            for name, _ in plan:
                c.run(name)
                out[(tenant, name)] = norm_result(c.result(name))
    except BaseException as exc:  # noqa: BLE001 — surfaced in the test
        errs.append(exc)


def test_concurrent_tenants_equal_serial_host_runs(tmp_path):
    plans = {"acme": [("s0", 0), ("s1", 1)],
             "umbrella": [("u0", 2), ("u1", 3)]}
    out, errs = {}, []
    with ServerThread(ServeConfig(store=str(tmp_path / "store"), max_live=2,
                                  **CPU)) as srv:
        threads = [threading.Thread(target=_tenant,
                                    args=(srv.port, t, p, out, errs))
                   for t, p in plans.items()]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=120)
        with Client("127.0.0.1", srv.port) as c:
            stats = c.stats()
    assert not errs
    for tenant, plan in plans.items():
        for name, seed in plan:
            assert out[(tenant, name)] == host_result(seed=seed)
    assert stats["registry"]["evictions"] > 0
    assert stats["registry"]["rehydrations"] > 0


# --------------------------------------------------------------------------- #
# stores crossing between the packages                                         #
# --------------------------------------------------------------------------- #
INJECT = {"kind": "fail", "t": 3100.0, "nodes": [2, 3]}


def _write_store(registry):
    """Two sessions: one evicted (a snapshot), then each given journaled
    ops after it, and no clean shutdown."""
    for name, seed in (("a", 0), ("b", 1)):
        registry.apply_mutating("t", name, "open", OPEN, seq=0)
        registry.apply_mutating("t", name, "submit",
                                dict(SUBMIT, seed=seed), seq=1)
        registry.apply_mutating("t", name, "step_until", {"t": 3000.0},
                                seq=2)
    registry.evict("t", "a")
    registry.apply_mutating("t", "a", "inject", dict(INJECT), seq=3)
    registry.apply_mutating("t", "b", "inject", dict(INJECT), seq=3)


def _finish(client_cls, port):
    with client_cls("127.0.0.1", port, tenant="t") as c:
        out = {}
        for name in ("a", "b"):
            c.call("run", name, seq=4)
            out[name] = norm_result(c.result(name))
        return out


@pytest.mark.parametrize("direction", ["reference-to-port",
                                       "port-to-reference"])
def test_a_store_crosses_between_the_packages(tmp_path, direction):
    root = str(tmp_path / "store")
    if direction == "reference-to-port":
        _write_store(RefRegistry(RefStore(root)))
        with ServerThread(ServeConfig(store=root, **CPU)) as srv:
            got = _finish(Client, srv.port)
    else:
        _write_store(SessionRegistry(SessionStore(root), device="cpu"))
        with RefServerThread(RefConfig(store=root)) as srv:
            got = _finish(RefClient, srv.port)
    assert got["a"] == host_result(seed=0, until=3000.0, inject=INJECT)
    assert got["b"] == host_result(seed=1, until=3000.0, inject=INJECT)


# --------------------------------------------------------------------------- #
# kill -9 of a real server process                                             #
# --------------------------------------------------------------------------- #
def _spawn_server(store, port_file):
    proc = subprocess.Popen(
        [sys.executable, "-m", "repro_torch", "serve", "--store", store,
         "--port-file", port_file, "--device", "cpu"],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        env={**os.environ, "PYTHONPATH": os.pathsep.join(sys.path)})
    deadline = time.monotonic() + 90
    while time.monotonic() < deadline:
        if os.path.exists(port_file):
            return proc, int(open(port_file).read())
        if proc.poll() is not None:
            raise RuntimeError("server died at startup:\n"
                               + proc.stdout.read().decode())
        time.sleep(0.05)
    proc.kill()
    raise RuntimeError("server did not announce a port within 90s")


def test_kill9_recovery_equals_the_host_run(tmp_path):
    store, port_file = str(tmp_path / "store"), str(tmp_path / "port")
    proc, port = _spawn_server(store, port_file)
    try:
        with Client("127.0.0.1", port, tenant="t") as c:
            c.open("s0", POLICY, nodes=NODES)
            c.submit("s0", workload="lublin", jobs=30, seed=0, nodes=NODES)
            c.step_until("s0", 4000.0)
        os.kill(proc.pid, signal.SIGKILL)        # no cleanup, no persist
        proc.wait(timeout=30)
        os.unlink(port_file)

        proc, port = _spawn_server(store, port_file)
        c = Client("127.0.0.1", port, tenant="t", retry_for=10.0)
        assert c.call("open", "s0", seq=0, **OPEN)["dup"]
        assert c.call("submit", "s0", seq=1, **SUBMIT)["dup"]
        assert c.call("step_until", "s0", seq=2, t=4000.0)["dup"]
        c.call("run", "s0", seq=3)
        got = norm_result(c.result("s0"))
        c.close()
    finally:
        proc.kill()
        proc.wait(timeout=30)
    assert got == host_result(until=4000.0)


# --------------------------------------------------------------------------- #
# a fault of the allocation backend                                            #
# --------------------------------------------------------------------------- #
@pytest.fixture
def on_card_classes(monkeypatch):
    """Classify the backend's device work as on the card, where a failure
    of it is a ``BackendFault``, while the sessions run on the CPU."""
    real = alloc_torch._device_work
    monkeypatch.setattr(alloc_torch, "_device_work",
                        lambda device: real(torch.device("cuda")))


@pytest.fixture
def failing_device(monkeypatch, on_card_classes):
    """Make every OPT=MIN launch after the first ``calls["ok"]`` fail as
    a lost device would."""
    calls = {"n": 0, "ok": 3}
    real = alloc_torch.ops.maxmin_solve

    def maxmin_solve(*args):
        calls["n"] += 1
        if calls["n"] > calls["ok"]:
            raise RuntimeError("CUDA error: an illegal memory access")
        return real(*args)

    monkeypatch.setattr(alloc_torch.ops, "maxmin_solve", maxmin_solve)
    return calls


def test_device_work_failures_are_backend_faults_on_the_card_only():
    for exc in (RuntimeError("CUDA error: launch failure"),
                ValueError("refused"), AssertionError("no CUDA")):
        with pytest.raises(BackendFault) as ei:
            with alloc_torch._device_work(torch.device("cuda")):
                raise exc
        assert ei.value.__cause__ is exc
    fault = BackendFault("lost")
    with pytest.raises(BackendFault) as ei:
        with alloc_torch._device_work(torch.device("cuda")):
            raise fault
    assert ei.value is fault
    with pytest.raises(RuntimeError) as ei:
        with alloc_torch._device_work(torch.device("cpu")):
            raise RuntimeError("plain")
    assert type(ei.value) is RuntimeError


def test_a_host_error_in_the_backend_is_an_op_error(tmp_path, monkeypatch,
                                                    on_card_classes):
    """The backend's host work (here densifying the incidence) fails as
    the simulation's inputs would, identically on a replay: the reference
    answers op-error for that session and serves on."""
    real = alloc_torch.densify_csr
    state = {"fail": False}

    def densify(*args, **kwargs):
        if state["fail"]:
            raise ValueError("incidence out of range")
        return real(*args, **kwargs)

    monkeypatch.setattr(alloc_torch, "densify_csr", densify)
    root = str(tmp_path / "store")
    with ServerThread(ServeConfig(store=root, **CPU)) as srv:
        with Client("127.0.0.1", srv.port, tenant="t") as c:
            c.open("s0", POLICY, nodes=NODES)
            c.submit("s0", workload="lublin", jobs=30, seed=0, nodes=NODES)
            state["fail"] = True
            with pytest.raises(ServeError) as ei:
                c.step_until("s0", 4000.0)
            assert ei.value.code == E_OP_ERROR
            assert "incidence out of range" in str(ei.value)
            journal = SessionStore(root).read_journal("t", "s0")
            assert [e["op"] for e in journal] == ["open", "submit",
                                                  "step_until"]
            state["fail"] = False
            c.open("s1", POLICY, nodes=NODES)
            c.submit("s1", workload="lublin", jobs=30, seed=0, nodes=NODES)
            c.step_until("s1", 4000.0)
            c.run("s1")
            got = norm_result(c.result("s1"))
        assert srv.error is None
    assert got == host_result(until=4000.0)


def _wait_stopped(srv):
    srv._thread.join(timeout=30)
    assert not srv._thread.is_alive()


def test_a_backend_fault_stops_the_server_and_recovers_exactly(
        tmp_path, failing_device):
    root = str(tmp_path / "store")
    srv = ServerThread(ServeConfig(store=root, **CPU)).start()
    c = Client("127.0.0.1", srv.port, tenant="t")
    c.open("s0", POLICY, nodes=NODES)
    c.submit("s0", workload="lublin", jobs=30, seed=0, nodes=NODES)
    with pytest.raises((ConnectionError, OSError)):
        c.step_until("s0", 4000.0)      # no response: the server stopped
    c.close()
    _wait_stopped(srv)
    assert isinstance(srv.error, BackendFault)
    assert "illegal memory access" in str(srv.error)
    # the op is in the journal as an op, and nothing was persisted
    journal = SessionStore(root).read_journal("t", "s0")
    assert [e["op"] for e in journal] == ["open", "submit", "step_until"]
    assert SessionStore(root).read_snapshot("t", "s0") is None

    failing_device["ok"] = 10**9                # the device is back
    with ServerThread(ServeConfig(store=root, **CPU)) as srv2:
        with Client("127.0.0.1", srv2.port, tenant="t", retry_for=5.0) as c:
            assert c.call("step_until", "s0", seq=2, t=4000.0)["dup"]
            c.call("run", "s0", seq=3)
            got = norm_result(c.result("s0"))
    assert got == host_result(until=4000.0)


def test_a_backend_fault_during_replay_is_not_swallowed(tmp_path,
                                                        failing_device):
    root = str(tmp_path / "store")
    reg = SessionRegistry(SessionStore(root), device="cpu")
    failing_device["ok"] = 10**9
    reg.apply_mutating("t", "s0", "open", OPEN, seq=0)
    reg.apply_mutating("t", "s0", "submit", SUBMIT, seq=1)
    reg.apply_mutating("t", "s0", "step_until", {"t": 4000.0}, seq=2)
    del reg                                     # a crash
    failing_device["n"], failing_device["ok"] = 0, 2
    srv = ServerThread(ServeConfig(store=root, **CPU)).start()
    c = Client("127.0.0.1", srv.port, tenant="t")
    with pytest.raises((ConnectionError, OSError)):
        c.result("s0")                          # rehydrates: the replay faults
    c.close()
    _wait_stopped(srv)
    assert isinstance(srv.error, BackendFault)
    assert len(SessionStore(root).read_journal("t", "s0")) == 3
