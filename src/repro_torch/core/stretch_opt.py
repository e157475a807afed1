"""MCB8-stretch — direct (estimated-)stretch minimization (paper §4.7).

Runs only periodically (needs the scheduling period T).  At a scheduling
event, the best non-clairvoyant estimate of job j's stretch one period ahead
is  Ŝ_j = (ft_j + T) / (vt_j + y_j·T).  Given a target Ŝ, the required yield
is  y_j = ((ft_j + T)/Ŝ - vt_j) / T  (clamped to [0, 1]; > 1 ⇒ infeasible).
A binary search over 1/Ŝ ∈ (0, 1] finds the smallest feasible target, with
MCB8 packing checking feasibility; if no target is feasible the lowest
priority job is removed (as in §4.3).

Post-passes: OPT=MAX iteratively lowers the maximum estimated stretch using
left-over node capacity (water-filling in stretch space); OPT=AVG maximizes
the total projected progress Σ y_j·T/(ft_j+T) (linear proxy for average
stretch minimization) with HiGHS.

The probe loop and both post-passes run on flat arrays (candidate columns
precomputed once per call, per-node usage via an in-order ``np.add.at``
scatter, added in list order).  Jobs are job views
(:class:`~repro_torch.core.state.JobView`).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

import numpy as np

from . import alloc_kernels, alloc_reference
from .mcb8 import _Candidates

__all__ = ["StretchResult", "mcb8_stretch", "improve_max_stretch", "improve_avg_stretch"]

_EPS = 1e-9


@dataclass
class StretchResult:
    mappings: Dict[int, List[int]]
    yields: Dict[int, float]       # initial per-job yields for the target
    target: float                  # achieved estimated max stretch
    removed: List[int]


def mcb8_stretch(
    candidates: Sequence,
    n_nodes: int,
    now: float,
    period: float,
    pinned: Optional[Dict[int, List[int]]] = None,
    accuracy: float = 0.01,
    alive: Optional[np.ndarray] = None,
) -> StretchResult:
    pinned = dict(pinned or {})
    active = sorted(candidates, key=lambda js: js.priority_key(now))  # incr prio
    removed: List[int] = []

    # flat candidate columns, priority order (suffixes drop removed heads)
    cand = _Candidates(active, pinned)
    ft_a = np.array([js.flow_time(now) for js in active])
    vt_a = np.array([js.vt for js in active])

    def feasible(inv_s: float, k: int):
        target = 1.0 / inv_s
        y = ((ft_a[k:] + period) / target - vt_a[k:]) / period
        if (y > 1.0 + _EPS).any():
            return None
        y = np.clip(y, 0.0, 1.0)
        ylds = {int(j): float(v) for j, v in zip(cand.jid[k:], y)}
        pack = cand.pack_probe(y * cand.cpu[k:], k, n_nodes, alive)
        if pack is None:
            return None
        return pack, ylds

    k0 = 0
    while True:
        if k0 >= len(active):
            return StretchResult({}, {}, np.inf, removed)
        base = feasible(accuracy, k0)  # very lax target (stretch 100)
        if base is None:
            removed.append(active[k0].spec.jid)
            k0 += 1
            continue
        best, best_inv = base, accuracy
        top = feasible(1.0, k0)        # stretch-1 target
        if top is not None:
            return StretchResult(top[0], top[1], 1.0, removed)
        lo, hi = accuracy, 1.0
        while hi - lo > accuracy:
            mid = 0.5 * (lo + hi)
            r = feasible(mid, k0)
            if r is not None:
                best, best_inv, lo = r, mid, mid
            else:
                hi = mid
        return StretchResult(best[0], best[1], 1.0 / best_inv, removed)


def improve_max_stretch(
    jobs: Sequence,
    mappings: Dict[int, List[int]],
    yields: Dict[int, float],
    n_nodes: int,
    now: float,
    period: float,
    max_rounds: int = 200,
) -> Dict[int, float]:
    """OPT=MAX (§4.7): iteratively reduce the max estimated stretch using
    slack — raise the worst job's yield until slack, cap, or the next-worst
    stretch level is reached."""
    if alloc_kernels.reference_kernels_active():
        return alloc_reference.improve_max_stretch(
            jobs, mappings, yields, n_nodes, now, period, max_rounds)
    jobs = [js for js in jobs if js.spec.jid in mappings]
    if not jobs:
        return yields
    m = len(jobs)
    yields = dict(yields)
    jid_a = [js.spec.jid for js in jobs]
    cpu_a = np.array([js.spec.cpu_need for js in jobs])
    ftp = np.array([js.flow_time(now) for js in jobs]) + period
    vt_a = np.array([js.vt for js in jobs])
    y_a = np.array([yields[j] for j in jid_a])
    # flat (job-position, node) scatter columns in job-then-task order: the
    # in-order np.add.at accumulation equals the reference per-task loop
    pos_flat = np.repeat(np.arange(m),
                         [len(mappings[j]) for j in jid_a])
    node_flat = np.concatenate(
        [np.asarray(mappings[j], dtype=np.int64) for j in jid_a])
    # per-job (node, multiplicity) in first-occurrence order, as the
    # reference's dict accumulation produces
    mult_of: List[Dict[int, int]] = []
    for j in jid_a:
        mult: Dict[int, int] = {}
        for node in mappings[j]:
            mult[node] = mult.get(node, 0) + 1
        mult_of.append(mult)

    frozen = np.zeros(m, dtype=bool)
    use = np.empty(n_nodes)
    for _ in range(max_rounds):
        live = ~frozen & (y_a < 1.0 - _EPS)
        if not live.any():
            break
        est = ftp / np.maximum(_EPS, vt_a + y_a * period)
        # first-maximal among live, in job order (== reference max(live, key))
        live_idx = np.nonzero(live)[0]
        w = int(live_idx[int(est[live_idx].argmax())])
        s_worst = float(est[w])
        others = np.delete(est, w)
        below = others[others < s_worst - 1e-12]
        s_next = float(below.max()) if below.size else 1.0
        target = max(s_next, 1.0)
        y_target = (ftp[w] / target - vt_a[w]) / period
        use[:] = 0.0
        np.add.at(use, node_flat, (y_a * cpu_a)[pos_flat])
        c = cpu_a[w]
        dy_slack = min(
            (1.0 - use[node]) / (c * k) for node, k in mult_of[w].items()
        )
        y_w = float(y_a[w])
        dy = min(max(0.0, float(y_target) - y_w), max(0.0, dy_slack),
                 1.0 - y_w)
        if dy <= 1e-6:
            frozen[w] = True
            continue
        y_a[w] = y_w + dy
    for i, j in enumerate(jid_a):
        yields[j] = float(y_a[i])
    return yields


def improve_avg_stretch(
    jobs: Sequence,
    mappings: Dict[int, List[int]],
    yields: Dict[int, float],
    n_nodes: int,
    now: float,
    period: float,
) -> Dict[int, float]:
    """OPT=AVG (§4.7): maximize Σ projected progress (linear proxy) with the
    achieved target as per-job floor."""
    if alloc_kernels.reference_kernels_active():
        return alloc_reference.improve_avg_stretch(
            jobs, mappings, yields, n_nodes, now, period)
    from scipy.optimize import linprog
    from scipy.sparse import csr_matrix

    jobs = [js for js in jobs if js.spec.jid in mappings]
    if not jobs:
        return yields
    m = len(jobs)
    dense = np.zeros((n_nodes, m))
    lo = np.zeros(m)
    w = np.zeros(m)
    for i, js in enumerate(jobs):
        nodes = np.asarray(mappings[js.spec.jid], dtype=np.int64)
        np.add.at(dense[:, i], nodes, js.spec.cpu_need)
        lo[i] = yields[js.spec.jid]
        w[i] = period / (js.flow_time(now) + period)
    res = linprog(
        c=-w,
        A_ub=csr_matrix(dense),
        b_ub=np.ones(n_nodes),
        bounds=list(zip(lo, np.ones(m))),
        method="highs",
    )
    out = dict(yields)
    if res.success:
        for i, js in enumerate(jobs):
            out[js.spec.jid] = float(np.clip(res.x[i], 0.0, 1.0))
    return out
