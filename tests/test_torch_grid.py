"""The sweep's process machinery in the port (``run_grid``'s host pool and
supervision, quarantine, ``SweepResult.save_json``, ``RecordCache``,
``run_branches`` with ``branch_seed`` and supervision) against the JAX
package's host paths, on the CPU.

Records are compared field for field, bit for bit, the wall-clock fields
and the ``backend`` tag aside.  A cache file written by either package's
``api.sweep`` must read in the other as all hits.
"""
import json
import multiprocessing as mp
import time

import pytest

from repro import api as ref_api
from repro.sched import sweep as ref_sweep_mod
from repro.sched.session import open_session as ref_open_session
from repro.sched.narrator import parse_narrator as ref_parse_narrator
from repro.sched.sweep import grid as ref_grid
from repro.sched.sweep import run_branches as ref_run_branches
from repro.sched.sweep import run_grid as ref_run_grid
from repro.workloads.registry import WorkloadSpec as RefWorkload
from repro.workloads.registry import make_trace_ir as ref_trace

from repro_torch import api
from repro_torch.sched import sweep as sweep_mod
from repro_torch.sched.narrator import parse_narrator
from repro_torch.sched.scenarios import SCENARIOS, register_scenario
from repro_torch.sched.session import open_session
from repro_torch.sched.sweep import (RecordCache, SweepResult, grid,
                                     run_branches, run_grid)
from repro_torch.workloads.registry import WorkloadSpec, make_trace_ir

CPU = dict(device="cpu")
_CLOCKS = ("wall_s", "sim_wall_s", "backend")
W = dict(kind="lublin", n_jobs=30, n_nodes=16, seed=2, load=0.8)
POLICIES = ["FCFS", "GreedyP */OPT=MIN"]
SCENARIOS_ = ["baseline", "rack_failure"]


def _outcomes(records, skip=()):
    return [{k: v for k, v in r.items() if k not in _CLOCKS + skip}
            for r in records]


def _baseline(records):
    """The reference's baseline cells, without their grid index."""
    return _outcomes([r for r in records if r["scenario"] == "baseline"],
                     skip=("cell",))


@pytest.fixture(scope="module")
def reference_records():
    return ref_run_grid(ref_grid([RefWorkload(**W)], POLICIES, SCENARIOS_),
                        compute_bound=True).records


@pytest.mark.parametrize("mode", [
    dict(n_workers=1), dict(n_workers=2), dict(n_workers=2, retries=1),
    dict(n_workers=1, timeout_s=60.0)],
    ids=["serial", "pooled", "supervised", "supervised-one-worker"])
def test_host_paths_equal_reference(mode, reference_records):
    res = run_grid(grid([WorkloadSpec(**W)], POLICIES, SCENARIOS_),
                   compute_bound=True, backend="numpy", **mode)
    assert res.n_quarantined == 0
    assert res.n_workers == (1 if mode["n_workers"] == 1 else 2)
    assert _outcomes(res.records) == _outcomes(reference_records)
    assert "backend" not in res.records[0]


def test_torch_path_equals_reference(reference_records):
    res = run_grid(grid([WorkloadSpec(**W)], POLICIES, SCENARIOS_),
                   compute_bound=True, **CPU)
    assert _outcomes(res.records) == _outcomes(reference_records)
    assert {r["backend"] for r in res.records} == {"torch"}
    assert res.alloc_stats["dispatches"] > 0


@pytest.fixture
def hang_scenario():
    """A scenario that never returns within a supervised budget (a wedged
    cell), registered for one test only; the pool's forked workers see
    it."""
    @register_scenario("test_hang")
    def _hang(trace, n_nodes, rng):
        time.sleep(600.0)
        return trace, []
    try:
        yield "test_hang"
    finally:
        SCENARIOS.pop("test_hang")


def test_supervised_pool_quarantines_raising_and_hanging_cells(
        reference_records, hang_scenario):
    """Healthy cells (30 jobs) finish far inside the 10 s budget; the
    hanging cell cannot finish within it.  Each loser is retried once on a
    fresh worker, then quarantined, and the sweep completes."""
    ok = WorkloadSpec(**W)
    cells = (grid([ok], POLICIES)
             + grid([ok], ["NOSUCH-POLICY"])          # raises in the worker
             + grid([ok], ["GreedyP */OPT=MIN"], [hang_scenario]))
    t0 = time.perf_counter()
    res = run_grid(cells, n_workers=2, timeout_s=10.0, retries=1,
                   compute_bound=True, backend="numpy")
    assert time.perf_counter() - t0 < 60.0
    assert res.n_cells == 4 and res.n_quarantined == 2
    healthy = [r for r in res.records if not r.get("quarantined")]
    assert _outcomes(healthy, skip=("cell",)) == _baseline(reference_records)
    bad = {r["scenario"]: r for r in res.quarantined}
    assert "NOSUCH-POLICY" in bad["baseline"]["error"]
    assert bad["baseline"]["attempts"] == 2
    assert "timeout after 10s" in bad["test_hang"]["error"]
    assert bad["test_hang"]["attempts"] == 2
    assert "mean_stretch" not in bad["test_hang"]
    assert set(res.summary(by="policy")) == set(POLICIES)


def test_supervision_on_the_device_path_quarantines(reference_records):
    cells = grid([WorkloadSpec(**W)], POLICIES + ["NOSUCH-POLICY"])
    with pytest.raises(ValueError, match="NOSUCH-POLICY"):
        run_grid(cells, **CPU)
    res = run_grid(cells, retries=1, compute_bound=True, **CPU)
    assert res.n_quarantined == 1
    assert "NOSUCH-POLICY" in res.quarantined[0]["error"]
    assert (_outcomes(res.records[:2], skip=("cell",))
            == _baseline(reference_records))


def test_pool_context_forks_only_while_the_card_is_uninitialized(
        monkeypatch):
    assert sweep_mod._pool_context().get_start_method() == "fork"
    monkeypatch.setattr(sweep_mod.torch.cuda, "is_initialized",
                        lambda: True)
    method = sweep_mod._pool_context().get_start_method()
    assert method in ("forkserver", "spawn")
    assert method in mp.get_all_start_methods()


def test_save_json_writes_the_sweep_artifact(tmp_path, reference_records):
    path = str(tmp_path / "out" / "sweep.json")
    res = run_grid(grid([WorkloadSpec(**W)], POLICIES, SCENARIOS_),
                   compute_bound=True, backend="numpy", json_path=path)
    with open(path) as f:
        payload = json.load(f)
    ref = ref_sweep_mod.SweepResult(records=reference_records, wall_s=1.0,
                                    n_workers=1).to_dict()
    assert set(payload) == set(ref)
    assert payload["schema"] == "repro.sweep/v1"
    assert payload["n_cells"] == 4 and payload["n_quarantined"] == 0
    assert _outcomes(payload["records"]) == _outcomes(
        json.loads(json.dumps(reference_records)))
    assert res.values("max_stretch", policy="FCFS").shape == (2,)
    empty = SweepResult(records=[], wall_s=0.0)
    assert empty.to_dict()["n_cells"] == 0


def _cells_simulated(monkeypatch, module):
    """Count the cells a RecordCache hands to its module's run_grid."""
    count = [0]
    real = module.run_grid

    def counting(cells, **kw):
        count[0] += len(cells)
        return real(cells, **kw)

    monkeypatch.setattr(module, "run_grid", counting)
    return count


SWEEP_ARGS = ([dict(W, seed=3), dict(W, seed=4)], ["greedy *", "EASY"],
              ["baseline", "rack_failure + arrival_burst"])


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_cache_file_crosses_the_packages(writer, tmp_path, monkeypatch):
    path = str(tmp_path / "cache.json")
    ws, pols, scs = SWEEP_ARGS
    mine = [WorkloadSpec(**w) for w in ws]
    theirs = [RefWorkload(**w) for w in ws]
    if writer == "reference":
        first = ref_api.sweep(theirs, pols, scs, cache_path=path).records
        count = _cells_simulated(monkeypatch, sweep_mod)
        second = api.sweep(mine, pols, scs, cache_path=path,
                           **CPU).records
    else:
        first = api.sweep(mine, pols, scs, cache_path=path, **CPU).records
        count = _cells_simulated(monkeypatch, ref_sweep_mod)
        second = ref_api.sweep(theirs, pols, scs, cache_path=path).records
    assert count[0] == 0                        # all hits
    assert len(first) == len(second) == 8
    assert second == json.loads(json.dumps(first))


def test_api_sweep_host_misses_equal_reference(tmp_path, monkeypatch):
    ws, pols, scs = SWEEP_ARGS
    mine = api.sweep([WorkloadSpec(**w) for w in ws], pols, scs,
                     backend="numpy", n_workers=2)
    ref = ref_api.sweep([RefWorkload(**w) for w in ws], pols, scs)
    assert _outcomes(mine.records) == _outcomes(ref.records)
    # a second spelling of one grid cell is one record
    count = _cells_simulated(monkeypatch, sweep_mod)
    cache = RecordCache(str(tmp_path / "c.json"))
    recs = cache.sweep([WorkloadSpec(**ws[0])], ["greedy *",
                                                 "Greedy */OPT=MIN"],
                       backend="numpy")
    assert count[0] == 1 and len(recs) == 2 and len(cache) == 1


def test_record_cache_truncated_file_is_a_miss(tmp_path, capsys):
    path = tmp_path / "cache.json"
    path.write_text('{"schema": "repro.sweep-cache/v1", "records": [')
    cache = RecordCache(str(path))
    assert len(cache) == 0
    assert "unreadable" in capsys.readouterr().err
    recs = cache.sweep([WorkloadSpec(**W)], ["FCFS"], backend="numpy")
    assert len(recs) == 1
    assert len(RecordCache(str(path))) == 1     # rewritten atomically


def test_record_cache_skips_malformed_and_refuses_foreign(tmp_path, capsys):
    path = tmp_path / "cache.json"
    good = RecordCache(str(path))
    good.sweep([WorkloadSpec(**W)], ["FCFS", "EASY"], backend="numpy")
    payload = json.loads(path.read_text())
    payload["records"][0]["params"] = 7         # malformed identity field
    payload["records"].append({"kind": "lublin"})   # older schema: skipped
    path.write_text(json.dumps(payload))
    cache = RecordCache(str(path))
    assert len(cache) == 1
    assert "dropped 1 malformed" in capsys.readouterr().err
    foreign = tmp_path / "foreign.json"
    foreign.write_text(json.dumps({"schema": "repro.sweep/v1"}))
    with pytest.raises(ValueError, match="refusing to overwrite"):
        RecordCache(str(foreign))


def test_record_cache_never_caches_quarantined(tmp_path):
    path = str(tmp_path / "cache.json")
    cache = RecordCache(path)
    recs = cache.sweep([WorkloadSpec(**W)], ["FCFS", "NOSUCH-POLICY"],
                       compute_bound=False, retries=1, **CPU)
    assert [bool(r.get("quarantined")) for r in recs] == [False, True]
    assert len(RecordCache(path)) == 1
    again = RecordCache(path).sweep([WorkloadSpec(**W)], ["FCFS"],
                                    compute_bound=False, backend="numpy")
    assert _outcomes(again)[0]["max_stretch"] == recs[0]["max_stretch"]


# --------------------------------------------------------------------------- #
# run_branches: branch_seed over a chaos snapshot, supervision                 #
# --------------------------------------------------------------------------- #
BRANCH_W = dict(kind="lublin", n_jobs=60, n_nodes=16, seed=0, load=0.9)
CHAOS = "breakdown(mtbf=3e2,repair=2e2)+cancel(rate=2e-3)+noise(sigma=0.3)"
BRANCHES = ["GreedyP */OPT=MIN", "GreedyPM */OPT=MIN", "EASY"]


def _chaos_snapshots():
    ses = open_session(16, "GreedyP */OPT=MIN", alloc_backend="numpy")
    ses.attach_narrator(parse_narrator(CHAOS, seed=7))
    ses.submit(make_trace_ir(WorkloadSpec(**BRANCH_W)))
    ref = ref_open_session(16, "GreedyP */OPT=MIN")
    ref.attach_narrator(ref_parse_narrator(CHAOS, seed=7))
    ref.submit(ref_trace(RefWorkload(**BRANCH_W)))
    for s in (ses, ref):
        s.step_until(700.0)
        s._wall = 0.0                   # a measurement, not state
    return ses.snapshot(), ref.snapshot()


@pytest.mark.parametrize("seed", [None, 9])
def test_branch_seed_over_a_chaos_snapshot_equals_reference(seed):
    snap, ref_snap = _chaos_snapshots()
    assert snap.fingerprint == ref_snap.fingerprint
    res = run_branches(snap, BRANCHES, branch_seed=seed, **CPU)
    ref = ref_run_branches(ref_snap, BRANCHES, branch_seed=seed)
    assert _outcomes(res.records) == _outcomes(ref.records)
    assert res.records[0]["exact_continuation"] == (seed is None)


def test_branch_seed_reseeds_the_chaos():
    snap, _ = _chaos_snapshots()
    a = run_branches(snap, BRANCHES[:1], backend="numpy").records[0]
    b = run_branches(snap, BRANCHES[:1], branch_seed=9,
                     backend="numpy").records[0]
    c = run_branches(snap, BRANCHES[:1], branch_seed=10,
                     backend="numpy").records[0]
    assert b["branch_seed"] == 9
    assert (a["max_stretch"], a["events"]) != (b["max_stretch"], b["events"]) \
        or (b["max_stretch"], b["events"]) != (c["max_stretch"], c["events"])


def test_supervised_branches_equal_serial_branches():
    snap, ref_snap = _chaos_snapshots()
    pols = BRANCHES + ["NoSuchPolicy"]
    sup = run_branches(snap, pols, branch_seed=9, timeout_s=60.0, retries=1,
                       backend="numpy", n_workers=2)
    dev = run_branches(snap, pols, branch_seed=9, timeout_s=60.0, **CPU)
    ref = ref_run_branches(ref_snap, pols, branch_seed=9, quarantine=True)
    assert [bool(r.get("quarantined")) for r in sup.records] == \
        [False, False, False, True]
    assert sup.records[3]["attempts"] == 2
    assert dev.records[3]["attempts"] == 1
    assert _outcomes(sup.records[:3]) == _outcomes(ref.records[:3])
    assert _outcomes(dev.records[:3]) == _outcomes(ref.records[:3])


# --------------------------------------------------------------------------- #
# the lockstep dispatcher: run token, targeted wake-ups, poison                #
# --------------------------------------------------------------------------- #
def test_lockstep_under_a_short_switch_interval(reference_records):
    """More lanes than cores and a switch interval of 1 µs: the rounds, the
    counters and every record stay those of the serial host run."""
    import sys

    cells = grid([WorkloadSpec(**W)] + [WorkloadSpec(**dict(W, seed=s))
                                        for s in (5, 6, 7)],
                 ["GreedyP */OPT=MIN", "EASY", "Greedy */OPT=AVG"],
                 SCENARIOS_)
    host = run_grid(cells, backend="numpy", compute_bound=True)
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        a = run_grid(cells, compute_bound=True, **CPU)
        b = run_grid(cells, compute_bound=True, **CPU)
    finally:
        sys.setswitchinterval(old)
    assert _outcomes(a.records) == _outcomes(host.records)
    assert _outcomes(b.records) == _outcomes(host.records)
    for key in ("dispatches", "rounds", "host_syncs"):
        assert a.alloc_stats[key] == b.alloc_stats[key], key


class _FailingAllocator:
    """Answers two rounds with the host numpy path, then raises."""

    def __init__(self):
        from repro_torch.core.yield_alloc import allocate_incidence
        self._allocate = allocate_incidence
        self.rounds = 0

    def allocate_many(self, requests):
        self.rounds += 1
        if self.rounds > 2:
            raise RuntimeError("device lost")
        return [self._allocate(inc, cols, opt=opt)
                for inc, cols, opt in requests]


def test_a_driver_error_poisons_every_lane_without_a_hang():
    import threading

    cells = grid([WorkloadSpec(**dict(W, seed=s)) for s in range(6)],
                 ["GreedyP */OPT=MIN"])
    out = {}

    def race():
        try:
            sweep_mod._race_in_lockstep(
                len(cells), _FailingAllocator(),
                lambda i, lane: sweep_mod._run_cell((i, cells[i], False),
                                                    alloc_backend=lane))
        except RuntimeError as exc:
            out["error"] = exc

    t = threading.Thread(target=race, daemon=True)
    t.start()
    t.join(timeout=60.0)
    assert not t.is_alive()
    assert "device lost" in str(out["error"])
