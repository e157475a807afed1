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

import numpy as np

from . import alloc_kernels
from .alloc_kernels import CSRIncidence

__all__ = ["allocate_incidence"]


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
