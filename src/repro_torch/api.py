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

    # the multi-tenant session server, its sessions on the card
    api.serve(store="var/serve", max_live=64)            # blocking
    c = api.connect(port=PORT, tenant="acme")
    c.open("s0", "GreedyP */OPT=MIN", nodes=128)

Every entry point takes ``device="cuda"`` unless the caller passes
``device="cpu"``; with no CUDA device the default raises.  The same
surface is scriptable as ``python -m repro_torch``.
"""
from __future__ import annotations

import time as _time
from dataclasses import replace
from typing import Any, Dict, Iterable, Optional, Sequence, Union

from .core.alloc_torch import TorchAllocBackend
from .core.bound import max_stretch_lower_bound
from .core.job import JobSpec
from .core.policies import (PolicySpec, TABLE1_POLICIES, all_paper_policies,
                            parse_policy, render_policy)
from .sched.cluster import ClusterEvent
from .sched.components import (ComposedPolicy, Component, compose,
                               compose_from_spec, get_component,
                               list_components, register_component,
                               register_policy, registered_policies,
                               resolve_policy)
from .sched.engine import Engine, Policy, SimParams, SimResult
from .sched.narrator import (Narrator, list_streams, narrator_docs,
                             parse_narrator, register_stream)
from .sched.scenarios import (apply_scenario, apply_scenario_trace,
                              list_reactive, list_scenarios,
                              parse_scenario_chain, reactive_docs,
                              register_reactive, register_scenario,
                              run_reactive, scenario_docs)
from .sched.session import SessionState, SimSession, open_session
from .sched.sweep import (Cell, RecordCache, SweepResult, grid, run_batched,
                          run_branches, run_grid)
from .serve.admission import CreditParams
from .serve.client import Client, ServeError, connect
from .serve.server import ServeConfig, ServerThread
from .serve.server import run_server as _run_server
from .tune import (AutoTuner, Objective, RaceResult, TuneConfig, Variant,
                   list_objectives, parse_objective, parse_tune, race)
from .workloads.registry import (WorkloadSpec, list_workloads, make_trace,
                                 make_trace_ir, parse_workload,
                                 register_workload, stream_trace,
                                 workload_kind)
from .workloads.trace import Trace, as_trace

__all__ = [
    # one-call entry points
    "simulate", "sweep", "list_policies",
    # streaming sessions
    "open_session", "SimSession", "SessionState",
    # scheduler-as-a-service (multi-tenant session server + client)
    "serve", "connect", "Client", "ServeError", "ServeConfig",
    "CreditParams", "ServerThread",
    # policy surface
    "PolicySpec", "parse_policy", "render_policy", "TABLE1_POLICIES",
    "all_paper_policies", "Policy", "ComposedPolicy", "Component",
    "compose", "compose_from_spec", "get_component", "list_components",
    "register_component", "register_policy", "registered_policies",
    "resolve_policy",
    # engine + metrics
    "Engine", "SimParams", "SimResult", "max_stretch_lower_bound",
    # workloads + scenarios
    "JobSpec", "Trace", "as_trace", "WorkloadSpec", "make_trace",
    "make_trace_ir", "parse_workload", "register_workload",
    "workload_kind", "list_workloads", "stream_trace",
    "ClusterEvent", "apply_scenario", "apply_scenario_trace",
    "parse_scenario_chain", "list_scenarios", "scenario_docs",
    "register_scenario",
    # reactive scenarios
    "run_reactive", "register_reactive", "list_reactive", "reactive_docs",
    # chaos narrator
    "Narrator", "parse_narrator", "register_stream", "list_streams",
    "narrator_docs",
    # sweeps
    "Cell", "SweepResult", "RecordCache", "grid", "run_grid", "run_batched",
    "run_branches",
    # online autotuning
    "autotune", "AutoTuner", "TuneConfig", "parse_tune", "race",
    "RaceResult", "Variant", "Objective", "parse_objective",
    "list_objectives",
]

TraceLike = Union[WorkloadSpec, Trace, Sequence[JobSpec]]
PolicyLike = Union[str, PolicySpec, Policy]


def simulate(
    trace: TraceLike,
    policy: PolicyLike,
    params: Optional[SimParams] = None,
    *,
    scenario: Optional[str] = None,
    cluster_events: Sequence[ClusterEvent] = (),
    seed: Optional[int] = None,
    device="cuda",
    **param_overrides: Any,
) -> SimResult:
    """Run one simulation cell, with its §4.6 reallocations on ``device``.

    ``trace`` is a declarative :class:`WorkloadSpec` (cluster size taken
    from the spec), a columnar :class:`Trace`, or a ``JobSpec`` sequence
    (for the latter two pass ``params`` or ``n_nodes=``).  ``policy`` is a
    grammar string, a registered composition name, a :class:`PolicySpec`,
    or a :class:`Policy`.  A named ``scenario`` — possibly a ``"a+b"``
    chain — perturbs the cell, seeded by ``seed`` (default: the
    workload's own seed, or 0 for a raw trace).  Extra keyword arguments
    override :class:`SimParams` fields.
    """
    if scenario is not None and cluster_events:
        raise ValueError("pass either scenario= or cluster_events=, not both")
    backend = TorchAllocBackend(device=device)
    explicit_n = param_overrides.pop("n_nodes", None)
    if isinstance(trace, WorkloadSpec):
        tr = make_trace_ir(trace)
        n_nodes = explicit_n or trace.n_nodes
        if seed is None:
            seed = trace.seed
    else:
        tr = as_trace(trace)
        n_nodes = explicit_n or (params.n_nodes if params is not None else None)
        if n_nodes is None:
            raise ValueError("pass SimParams (or n_nodes=) when simulating "
                             "a raw trace")
        if seed is None:
            seed = 0
    events: Sequence[ClusterEvent] = tuple(cluster_events)
    if scenario is not None:
        tr, events = apply_scenario_trace(scenario, tr, n_nodes, seed=seed)
    if params is None:
        params = SimParams(n_nodes=n_nodes, **param_overrides)
    else:
        params = replace(params, n_nodes=n_nodes, **param_overrides)
    return Engine(tr, policy, params, cluster_events=events,
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


def serve(
    host: str = "127.0.0.1",
    port: int = 0,
    *,
    store: Optional[str] = None,
    max_live: int = 256,
    idle_evict_s: Optional[float] = None,
    checkpoint_every: int = 0,
    credit: Optional[CreditParams] = None,
    announce=None,
    device="cuda",
    **credit_overrides: Any,
) -> None:
    """Run the multi-tenant session server (blocking), every session
    allocating on ``device``.

    JSONL-over-TCP, stdlib only, the JAX package's protocol.  ``store``
    enables the durable layer: write-ahead op journals, snapshot-backed
    eviction of idle sessions past ``max_live`` (and ``idle_evict_s``),
    and crash recovery — a restarted server replays persisted snapshots +
    journals and client retries dedupe on per-session seq, so a ``kill
    -9`` mid-workload resumes bit-identically.  Tenant fairness comes
    from the credit score ``clamp(1 − α·budget_used − β·violations −
    γ·tail_latency)`` weighting a DRF fair queue; tune via
    ``credit=CreditParams(...)`` or keyword overrides (``alpha=``,
    ``budget=``, ``max_pending=``, …).  With no CUDA device, the default
    ``device`` raises before a socket is bound.

    Use :class:`ServerThread` for an in-process background server, and
    :func:`connect` for a client.  ``announce(server)`` fires once the
    socket is bound (``server.port`` is then known).
    """
    if credit is None:
        credit = CreditParams(**credit_overrides)
    elif credit_overrides:
        raise ValueError("pass either credit= or keyword overrides, "
                         "not both")
    _run_server(ServeConfig(host=host, port=port, store=store,
                            max_live=max_live, idle_evict_s=idle_evict_s,
                            checkpoint_every=checkpoint_every,
                            credit=credit, device=device),
                announce=announce)


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


def list_policies(include_paper_space: bool = False) -> Dict[str, Any]:
    """The policy surface: Table-1 strings (canonicalized), registered
    component compositions, the component registry, and the size of the
    full §6.1 space (expanded with ``include_paper_space``)."""
    out: Dict[str, Any] = {
        "table1": [parse_policy(p).name for p in TABLE1_POLICIES],
        "registered": registered_policies(),
        "components": list_components(),
        "n_paper_space": len(all_paper_policies()),
    }
    if include_paper_space:
        out["paper_space"] = [parse_policy(p).name
                              for p in all_paper_policies()]
    return out
