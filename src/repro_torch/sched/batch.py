"""Batch-scheduling baselines: FCFS and EASY backfilling (paper §5.2).

The scheduling logic lives in the batch policy components and runs on the
same unified engine (and the same ``SimResult`` metrics pipeline) as the
DFRS policies; this module keeps the historical ``batch_schedule`` entry
point, with the engine's backend on ``device`` as ``api.simulate`` has it.
"""
from __future__ import annotations

from typing import Optional, Sequence

from ..core.alloc_torch import TorchAllocBackend
from ..core.job import JobSpec
from ..core.policies import parse_policy
from ._compat import BATCH_REPLACEMENT, warn_once
from .engine import Engine, SimParams, SimResult

__all__ = ["batch_schedule"]


def batch_schedule(
    specs: Sequence[JobSpec],
    algo: str,
    params: Optional[SimParams] = None,
    *,
    device="cuda",
) -> SimResult:
    warn_once("repro_torch.sched.batch.batch_schedule", BATCH_REPLACEMENT)
    backend = TorchAllocBackend(device=device)
    spec = parse_policy(algo)
    if not spec.is_batch:
        raise ValueError(algo)
    return Engine(specs, spec, params, alloc_backend=backend).run()
