"""EQUIPARTITION on a single unit-capacity resource (paper §3.2, Theorem 4).

Used for the theoretical analysis: every not-yet-completed job receives an
equal share 1/m(t) of the resource.  Jobs here are perfectly parallel /
single-task with need 1 (the Theorem-2/3/4 setting).  Returns completion
times; the simulation is exact (piecewise-constant shares between events).
"""
from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np

__all__ = ["equipartition_schedule", "max_stretch", "thm4_instance"]


def equipartition_schedule(
    releases: Sequence[float], proc_times: Sequence[float]
) -> List[float]:
    """Exact completion times under EQUIPARTITION on one unit resource."""
    n = len(releases)
    rem = np.asarray(proc_times, dtype=float).copy()
    rel = np.asarray(releases, dtype=float)
    done = np.full(n, np.inf)
    active = np.zeros(n, dtype=bool)
    order = np.argsort(rel, kind="stable")
    idx = 0
    t = float(rel[order[0]]) if n else 0.0
    while True:
        while idx < n and rel[order[idx]] <= t + 1e-15:
            active[order[idx]] = True
            idx += 1
        m = int(active.sum())
        if m == 0:
            if idx >= n:
                break
            t = float(rel[order[idx]])
            continue
        rate = 1.0 / m
        t_fin = t + rem[active].min() / rate          # next completion
        t_arr = float(rel[order[idx]]) if idx < n else np.inf
        t_next = min(t_fin, t_arr)
        rem[active] -= rate * (t_next - t)
        finished = active & (rem <= 1e-12)
        done[finished] = t_next
        active &= ~finished
        t = t_next
        if idx >= n and not active.any():
            break
    return list(done)


def max_stretch(
    releases: Sequence[float], proc_times: Sequence[float], completions: Sequence[float]
) -> float:
    s = [
        (c - r) / p
        for r, p, c in zip(releases, proc_times, completions)
    ]
    return max(s) if s else 0.0


def thm4_instance(n: int) -> Tuple[List[float], List[float]]:
    """The adversarial instance from Theorem 4's proof: p_1 = p_2 = n-1,
    p_i = (n-1)/(i-1) for i >= 3, releases r_1 = r_2 = 0,
    r_i = r_{i-1} + p_{i-1}.  Under EQUIPARTITION every job completes at
    r_n + n and the max stretch is n, while an optimal schedule achieves
    2 + sum_{i=2}^{n-1} 1/i."""
    assert n >= 3
    p = [0.0] * (n + 1)
    p[1] = p[2] = float(n - 1)
    for i in range(3, n + 1):
        p[i] = (n - 1) / (i - 1)
    r = [0.0] * (n + 1)
    r[1] = r[2] = 0.0
    for i in range(3, n + 1):
        r[i] = r[i - 1] + p[i - 1]
    return r[1:], p[1:]
