"""Back-compat front-end for the unified engine (see
``repro_torch.sched.engine``).

``DFRSSimulator`` and ``simulate`` are thin wrappers kept for callers of the
historical entry points — new code should use ``repro_torch.api`` (both
wrappers emit one DeprecationWarning per process).  Like ``api.simulate``
they run the §4.6 reallocations on ``device`` (``"cuda"`` unless the caller
asks for ``"cpu"``); with no CUDA device the default raises, batch
policies included.
"""
from __future__ import annotations

from typing import Optional, Sequence

from ..core.alloc_torch import TorchAllocBackend
from ..core.job import JobSpec
from ..core.policies import PolicySpec, parse_policy
from ._compat import BATCH_REPLACEMENT, warn_once
from .cluster import ClusterEvent
from .engine import Engine, SimParams, SimResult

__all__ = ["SimParams", "SimResult", "DFRSSimulator", "simulate"]


class DFRSSimulator(Engine):
    """DFRS-only front-end: rejects batch policies like the original class."""

    def __init__(
        self,
        specs: Sequence[JobSpec],
        policy: PolicySpec | str,
        params: Optional[SimParams] = None,
        cluster_events: Sequence[ClusterEvent] = (),
        *,
        device="cuda",
    ):
        warn_once("repro_torch.sched.simulator.DFRSSimulator",
                  BATCH_REPLACEMENT)
        backend = TorchAllocBackend(device=device)
        spec = parse_policy(policy) if isinstance(policy, str) else policy
        if spec.is_batch:
            raise ValueError("use repro_torch.sched.batch for FCFS/EASY")
        super().__init__(specs, spec, params, cluster_events,
                         alloc_backend=backend)


def simulate(
    specs: Sequence[JobSpec],
    policy: str,
    params: Optional[SimParams] = None,
    cluster_events: Sequence[ClusterEvent] = (),
    *,
    device="cuda",
) -> SimResult:
    """Run one policy (DFRS or FCFS/EASY) on a trace via the unified engine.

    Cluster events are ignored for the batch baselines (they do not model
    failures), matching the historical behaviour of this entry point.
    """
    warn_once("repro_torch.sched.simulator.simulate", BATCH_REPLACEMENT)
    backend = TorchAllocBackend(device=device)
    return Engine(specs, policy, params, cluster_events,
                  alloc_backend=backend).run()
