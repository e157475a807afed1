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

Every entry point takes ``device="cuda"`` unless the caller passes
``device="cpu"``; with no CUDA device the default raises.
"""
from __future__ import annotations

from dataclasses import replace
from typing import Any, Optional, Sequence, Union

from .core.alloc_torch import TorchAllocBackend
from .core.job import JobSpec
from .core.policies import PolicySpec
from .sched.cluster import ClusterEvent
from .sched.engine import Engine, Policy, SimParams, SimResult
from .sched.session import SessionState, SimSession, open_session
from .sched.sweep import Cell, SweepResult, grid, run_batched, run_branches
from .workloads.registry import (WorkloadSpec, list_workloads, make_trace_ir,
                                 stream_trace)
from .workloads.trace import Trace, as_trace

__all__ = ["simulate", "grid", "run_batched", "run_branches", "open_session",
           "SimSession", "SessionState", "stream_trace", "list_workloads",
           "WorkloadSpec", "Cell", "SweepResult", "SimParams", "SimResult",
           "Trace", "ClusterEvent"]

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
