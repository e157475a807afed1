"""repro_torch.api — the one-import facade over the ported scheduling path.

    from repro_torch import api

    # one cell on the card: the §4.6 reallocations run on the device
    r = api.simulate(api.WorkloadSpec("lublin", n_jobs=1000, n_nodes=128,
                                      load=0.7), "GreedyP */OPT=MIN")

    # many cells in lockstep on one device
    cells = api.grid([api.WorkloadSpec("lublin", n_jobs=1000, n_nodes=128,
                                       seed=s, load=0.7) for s in range(16)],
                     ["GreedyP */OPT=MIN", "EASY"])
    res = api.run_batched(cells)

    # an open session: stream a log through it, compacting finished rows
    ses = api.open_session(api.SimParams(n_nodes=128, compact_interval=4096),
                           "GreedyP */OPT=MIN")
    ses.stream(api.stream_trace(api.WorkloadSpec(
        "swf-stream", n_jobs=20000, n_nodes=128, params={"path": log})))
    r = ses.result()

    # what-if branches from a mid-run snapshot, raced in lockstep
    ses.step_until(t)
    res = api.run_branches(ses.snapshot(), ["GreedyPM */OPT=MIN", "EASY"])

    # a scenario grid with a resumable on-disk record cache; misses run on
    # the card (backend="numpy": the host process pool)
    res = api.sweep([api.WorkloadSpec("lublin", n_jobs=1000, n_nodes=128,
                                      load=0.7)],
                    ["GreedyP */OPT=MIN", "EASY"],
                    ["baseline", "rack_failure", "arrival_burst+mem_pressure"],
                    cache_path="experiments/results/cache.json")

    # chaos and an online autotuner on a live session
    ses = api.open_session(128, "GreedyP */OPT=MIN")
    ses.attach_narrator(api.parse_narrator(
        "breakdown(mtbf=2e3,repair=8e2)+noise(sigma=0.3)", seed=7))
    tuner = api.autotune(ses, "every=5000;horizon=4000;margin=0.01;"
                         "policies=GreedyPM */per/OPT=MIN/MINVT=600")
    ses.submit(api.WorkloadSpec("lublin", n_jobs=1000, n_nodes=128,
                                load=0.7))
    r = ses.run()

Every entry point takes ``device="cuda"`` unless the caller passes
``device="cpu"``; with no CUDA device the default raises.
"""
from __future__ import annotations

import time as _time
from dataclasses import replace
from typing import Any, Iterable, Optional, Sequence, Union

from .core.alloc_torch import TorchAllocBackend
from .core.job import JobSpec
from .core.policies import PolicySpec
from .sched.cluster import ClusterEvent
from .sched.engine import Engine, Policy, SimParams, SimResult
from .sched.narrator import Narrator, parse_narrator
from .sched.scenarios import (apply_scenario, apply_scenario_trace,
                              list_scenarios, run_reactive)
from .sched.session import SessionState, SimSession, open_session
from .sched.sweep import (Cell, RecordCache, SweepResult, grid, run_batched,
                          run_branches, run_grid)
from .tune import AutoTuner, TuneConfig, race
from .workloads.registry import (WorkloadSpec, list_workloads, make_trace_ir,
                                 parse_workload, stream_trace)
from .workloads.trace import Trace, as_trace

__all__ = ["simulate", "sweep", "grid", "run_grid", "run_batched",
           "run_branches", "RecordCache", "open_session", "SimSession",
           "SessionState", "stream_trace", "list_workloads", "parse_workload",
           "WorkloadSpec", "Cell", "SweepResult", "SimParams", "SimResult",
           "Trace", "ClusterEvent", "apply_scenario", "apply_scenario_trace",
           "list_scenarios", "run_reactive", "Narrator", "parse_narrator",
           "autotune", "AutoTuner", "TuneConfig", "race"]

TraceLike = Union[WorkloadSpec, Trace, Sequence[JobSpec]]
PolicyLike = Union[str, PolicySpec, Policy]


def simulate(
    trace: TraceLike,
    policy: PolicyLike,
    params: Optional[SimParams] = None,
    *,
    cluster_events: Sequence[ClusterEvent] = (),
    device="cuda",
    **param_overrides: Any,
) -> SimResult:
    """Run one simulation cell, with its §4.6 reallocations on ``device``.

    ``trace`` is a declarative :class:`WorkloadSpec` (cluster size taken
    from the spec), a columnar :class:`Trace`, or a ``JobSpec`` sequence
    (for the latter two pass ``params`` or ``n_nodes=``).  ``policy`` is a
    grammar string, a registered composition name, a :class:`PolicySpec`,
    or a :class:`Policy`.  Extra keyword arguments override
    :class:`SimParams` fields.
    """
    backend = TorchAllocBackend(device=device)
    explicit_n = param_overrides.pop("n_nodes", None)
    if isinstance(trace, WorkloadSpec):
        tr = make_trace_ir(trace)
        n_nodes = explicit_n or trace.n_nodes
    else:
        tr = as_trace(trace)
        n_nodes = explicit_n or (params.n_nodes if params is not None else None)
        if n_nodes is None:
            raise ValueError("pass SimParams (or n_nodes=) when simulating "
                             "a raw trace")
    if params is None:
        params = SimParams(n_nodes=n_nodes, **param_overrides)
    else:
        params = replace(params, n_nodes=n_nodes, **param_overrides)
    return Engine(tr, policy, params, cluster_events=cluster_events,
                  alloc_backend=backend).run()


def sweep(
    workloads: Iterable[WorkloadSpec],
    policies: Iterable[str],
    scenarios: Iterable[str] = ("baseline",),
    *,
    periods: Iterable[float] = (600.0,),
    params: Optional[SimParams] = None,
    n_workers: int = 1,
    compute_bound: bool = True,
    cache_path: Optional[str] = None,
    json_path: Optional[str] = None,
    timeout_s: Optional[float] = None,
    retries: int = 0,
    backend: str = "torch",
    device="cuda",
) -> SweepResult:
    """Evaluate a (workload × policy × period × scenario) grid.

    Records are memoized in a :class:`RecordCache` (equivalent policy
    spellings share one simulated cell).  With ``cache_path`` the cache
    lives in a JSON file rewritten atomically after every miss batch, so
    interrupted sweeps resume where they stopped and repeated sweeps over
    overlapping grids are incremental.  ``json_path`` additionally writes
    the plain ``repro.sweep/v1`` artifact.

    The misses run on the card (``run_grid(backend="torch")`` on
    ``device``) unless the caller passes ``backend="numpy"``, the host
    process pool of ``n_workers``.  ``timeout_s``/``retries`` supervise the
    misses: cells that exhaust them come back as quarantine records
    (``quarantined=True``, never cached) and the sweep still completes.
    """
    workloads, policies = list(workloads), list(policies)
    scenarios, periods = list(scenarios), [float(p) for p in periods]
    t0 = _time.perf_counter()
    cache = RecordCache(cache_path)
    records = cache.sweep(workloads, policies, periods, scenarios,
                          params=params, n_workers=n_workers,
                          compute_bound=compute_bound,
                          timeout_s=timeout_s, retries=retries,
                          backend=backend, device=device)
    res = SweepResult(records=list(records),
                      wall_s=_time.perf_counter() - t0,
                      n_workers=n_workers)
    if json_path is not None:
        res.save_json(json_path)
    return res


def autotune(
    session: SimSession,
    config: Union[str, TuneConfig, None] = None,
    *,
    seed: int = 0,
    log_path: Optional[str] = None,
) -> AutoTuner:
    """Put a live session under online what-if autotuning.

    Builds an :class:`AutoTuner` (``config`` is a :class:`TuneConfig`, a
    ``parse_tune`` spec string like
    ``"every=5000;policies=GreedyP */OPT=MIN|GreedyPM */per/OPT=MIN/MINVT=600"``,
    or ``None`` for defaults), attaches it, and returns it.  From then on
    the stepping loop periodically forks the session, races the portfolio
    over a bounded horizon with successive halving — in lockstep on the
    session's device — and hot-swaps a decisively better variant in
    (hysteresis + min-dwell).  Decisions accumulate on ``tuner.decisions``
    (and ``log_path`` as JSONL); tuner state rides ``session.snapshot()``
    bit-exactly.
    """
    tuner = AutoTuner(config, seed=seed, log_path=log_path)
    session.attach_autotuner(tuner)
    return tuner
