"""Evaluation metrics (paper §2.2, §6.1, §6.4).

* bounded stretch — turnaround replaced by a threshold (10 s) when smaller;
* degradation from bound — max bounded stretch / Theorem-1 lower bound;
* normalized underutilization — ∫ (min(|P|, demand) − useful allocation) dt
  divided by the total work of the trace.
"""
from __future__ import annotations

from typing import Dict, Sequence

import numpy as np

from ..core.bound import max_stretch_lower_bound
from ..core.job import JobSpec

__all__ = [
    "bounded_stretch",
    "max_bounded_stretch",
    "degradation_from_bound",
    "normalized_underutilization",
]


def bounded_stretch(turnaround: float, proc_time: float, tau: float = 10.0) -> float:
    """max(T, tau) / p  (paper §2.2: 'bounded slowdown' variant)."""
    return max(turnaround, tau) / proc_time


def max_bounded_stretch(
    specs: Sequence[JobSpec], completions: Dict[int, float], tau: float = 10.0
) -> float:
    return max(
        bounded_stretch(completions[s.jid] - s.release, s.proc_time, tau)
        for s in specs
    )


def degradation_from_bound(
    specs: Sequence[JobSpec],
    achieved_max_stretch: float,
    n_nodes: int,
    tau: float = 10.0,
    bound: float | None = None,
) -> float:
    """Ratio to the Theorem-1 offline clairvoyant lower bound (§6.1)."""
    if bound is None:
        bound = max_stretch_lower_bound(specs, n_nodes, tau)
    return achieved_max_stretch / bound


def normalized_underutilization(
    underutil_integral: float, specs: Sequence[JobSpec]
) -> float:
    total = sum(s.total_work for s in specs)
    return underutil_integral / max(total, 1e-12)
