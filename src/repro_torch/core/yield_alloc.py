"""Resource (CPU fraction) allocation given a fixed task→node mapping (§4.6).

Step 1 (always): every job gets yield 1/max(1, Λ) where Λ is the maximum node
CPU load — this maximizes the minimum yield for the given mapping.

Step 2 (OPT=MIN): iterated max-min improvement (water-filling): freeze the
jobs on the bottleneck node at the bottleneck level and keep raising the
rest, until every job is frozen or capped at yield 1.

Step 2' (OPT=AVG): maximize the *average* yield subject to no job dropping
below the step-1 minimum — a rational LP (paper Linear Program (2)), solved
with scipy's HiGHS.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np

from . import alloc_kernels, alloc_reference
from .alloc_kernels import CSRIncidence, build_csr
from .job import JobSpec

__all__ = ["min_yield", "maxmin_yields", "avg_yields", "allocate",
           "allocate_incidence"]


def min_yield(max_load: float) -> float:
    """Equal yield maximizing the minimum for a given max node load Λ."""
    return 1.0 / max(1.0, max_load)


def maxmin_yields(
    specs: Sequence[JobSpec],
    mappings: Sequence[Sequence[int]],
    n_nodes: int,
) -> np.ndarray:
    """OPT=MIN: lexicographic max-min yields for the given mapping."""
    if alloc_kernels.reference_kernels_active():
        return alloc_reference.maxmin_yields(specs, mappings, n_nodes)
    m = len(specs)
    if m == 0:
        return np.zeros(0)
    inc = build_csr([s.cpu_need for s in specs], mappings, n_nodes)
    return alloc_kernels.maxmin_yields_csr(inc, np.ones(m, dtype=bool))


def avg_yields(
    specs: Sequence[JobSpec],
    mappings: Sequence[Sequence[int]],
    n_nodes: int,
) -> np.ndarray:
    """OPT=AVG: maximize sum of yields s.t. y_j >= 1/max(1,Λ) (LP (2))."""
    if alloc_kernels.reference_kernels_active():
        return alloc_reference.avg_yields(specs, mappings, n_nodes)
    m = len(specs)
    if m == 0:
        return np.zeros(0)
    inc = build_csr([s.cpu_need for s in specs], mappings, n_nodes)
    return alloc_kernels.avg_yields_csr(inc, np.arange(m, dtype=np.int64))


def allocate(
    specs: Sequence[JobSpec],
    mappings: Sequence[Sequence[int]],
    n_nodes: int,
    opt: str = "MIN",
) -> np.ndarray:
    """Full §4.6 allocation: equal min-yield floor + OPT=MIN / OPT=AVG pass
    (the engine's path under :func:`~.alloc_kernels.reference_kernels`)."""
    if opt == "MIN":
        return maxmin_yields(specs, mappings, n_nodes)
    if opt == "AVG":
        return avg_yields(specs, mappings, n_nodes)
    raise ValueError(f"unknown OPT {opt!r}")


def allocate_incidence(
    inc: CSRIncidence,
    cols: np.ndarray,
    opt: str = "MIN",
) -> np.ndarray:
    """§4.6 allocation straight off an engine incidence snapshot (the host
    numpy path).

    ``cols`` — sorted job columns of the running set.  Returns yields aligned
    with ``cols``.
    """
    if opt == "MIN":
        active = np.zeros(inc.width, dtype=bool)
        active[cols] = True
        return alloc_kernels.maxmin_yields_csr(inc, active)[cols]
    if opt == "AVG":
        return alloc_kernels.avg_yields_csr(inc, cols)
    raise ValueError(f"unknown OPT {opt!r}")
