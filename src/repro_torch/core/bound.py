"""Offline lower bound on the optimal maximum (bounded) stretch (paper §3.1).

Theorem 1: a max-stretch target S is achievable (infinite memory, free
instantaneous migration) iff a feasibility LP over the release/deadline
intervals has a solution.  That LP is a transportation problem, so we check
feasibility with a max-flow instead of a general LP:

    source -> job j           capacity  n_j * p_j * c_j      (total work)
    job j  -> interval t      capacity  n_j * l(t)           (Constraint 1d)
    interval t -> sink        capacity  |P| * l(t)           (Constraint 1e)

(job->interval edges only for intervals inside [r_j, d_j), Constraints 1b/1c;
Constraint 1a == full flow value.)  A binary search on S yields the optimal
target within ``rtol``.  With the *bounded* stretch (threshold tau, §2.2)
job j additionally requires S >= tau / p_j, so the search starts at
S_lo = max(1, tau / min_j p_j).

Capacities are scaled to integers with demands rounded *down* and capacities
rounded *up*, so "feasible" is never falsely rejected and the returned value
remains a true lower bound.
"""
from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
from scipy.sparse import csr_matrix
from scipy.sparse.csgraph import maximum_flow

from .job import JobSpec

__all__ = ["stretch_feasible", "max_stretch_lower_bound"]

_SCALE_TARGET = 10**8   # keep total integer flow comfortably inside int64


def _intervals(bounds: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    pts = np.unique(bounds)
    return pts[:-1], pts[1:]


def stretch_feasible(
    specs: Sequence[JobSpec], n_nodes: int, s: float, tau: float = 10.0
) -> bool:
    """Max-flow feasibility of max-stretch target ``s`` (Theorem 1)."""
    r = np.array([sp.release for sp in specs])
    d = r + s * np.array([sp.proc_time for sp in specs])
    lo, hi = _intervals(np.concatenate([r, d]))
    ell = hi - lo
    n_j, n_t = len(specs), len(ell)
    work = np.array([sp.total_work for sp in specs])
    total = work.sum()
    if total <= 0:
        return True
    scale = _SCALE_TARGET / max(total, n_nodes * ell.sum(), 1e-9)

    # node ids: 0 = source, 1..n_j = jobs, n_j+1..n_j+n_t = intervals, last = sink
    src, snk = 0, n_j + n_t + 1
    rows: List[int] = []
    cols: List[int] = []
    caps: List[int] = []
    demand = np.floor(work * scale).astype(np.int64)
    for j in range(n_j):
        rows.append(src); cols.append(1 + j); caps.append(int(demand[j]))
    t_cap = np.ceil(n_nodes * ell * scale).astype(np.int64)
    for t in range(n_t):
        rows.append(1 + n_j + t); cols.append(snk); caps.append(int(t_cap[t]))
    for j, sp in enumerate(specs):
        t0 = int(np.searchsorted(lo, r[j], side="left"))
        t1 = int(np.searchsorted(lo, d[j] - 1e-12, side="right"))
        for t in range(t0, t1):
            cap = int(np.ceil(sp.n_tasks * ell[t] * scale))
            if cap > 0:
                rows.append(1 + j); cols.append(1 + n_j + t); caps.append(cap)
    g = csr_matrix(
        (np.asarray(caps, dtype=np.int64), (rows, cols)),
        shape=(snk + 1, snk + 1),
    )
    flow = maximum_flow(g, src, snk).flow_value
    return flow >= int(demand.sum())


def max_stretch_lower_bound(
    specs: Sequence[JobSpec],
    n_nodes: int,
    tau: float = 10.0,
    rtol: float = 1e-3,
) -> float:
    """Binary-search lower bound on the optimal max bounded stretch."""
    specs = list(specs)
    if not specs:
        return 1.0
    p_min = min(sp.proc_time for sp in specs)
    s_lo = max(1.0, tau / p_min)
    if stretch_feasible(specs, n_nodes, s_lo, tau):
        return s_lo
    s_hi = s_lo * 2.0
    while not stretch_feasible(specs, n_nodes, s_hi, tau):
        s_hi *= 2.0
        if s_hi > 1e9:
            return s_hi  # degenerate instance
    while (s_hi - s_lo) / s_hi > rtol:
        mid = 0.5 * (s_lo + s_hi)
        if stretch_feasible(specs, n_nodes, mid, tau):
            s_hi = mid
        else:
            s_lo = mid
    return s_hi
