"""Greedy task-mapping heuristics (paper §4.2).

* ``greedy_place``     — map an incoming job without disturbing running jobs.
* ``greedy_p``         — GreedyP: additionally pause lower-priority running
                         jobs (by increasing priority) to force admission.
* ``greedy_pm``        — GreedyPM: like GreedyP, but paused victims get a
                         chance to be *moved* (re-placed via Greedy) instead.

All functions are pure with respect to the passed-in ``NodePool`` copies;
they return placement decisions, the caller (engine) applies them and does
penalty/bandwidth accounting.

``greedy_place`` keeps one masked candidate-load array per call and updates
only the chosen node after each task placement.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence

import numpy as np

from . import alloc_kernels, alloc_reference
from .job import JobSpec, NodePool
from .state import JobView

__all__ = ["greedy_place", "GreedyAdmission", "greedy_p", "greedy_pm"]


def greedy_place(pool: NodePool, spec: JobSpec) -> Optional[List[int]]:
    """Map each task of ``spec`` to the feasible node with the lowest CPU
    load (§4.2), updating ``pool`` in place.  Returns the mapping or None if
    some task cannot fit in memory (pool is then left unmodified)."""
    if alloc_kernels.reference_kernels_active():
        return alloc_reference.greedy_place(pool, spec)
    # one masked-load array per call; only the chosen node changes per task
    masked = pool.masked_loads(spec.mem_req)
    if masked.size == 0:
        return None
    load, mem_free = pool.load, pool.mem_free
    cpu_need, mem_req = spec.cpu_need, spec.mem_req
    thr = mem_req - 1e-12
    mapping: List[int] = []
    for _ in range(spec.n_tasks):
        node = int(masked.argmin())
        if masked[node] == np.inf:          # no feasible node
            if mapping:
                pool.remove(spec, mapping)
            return None
        mapping.append(node)
        load[node] += cpu_need
        mem_free[node] -= mem_req
        masked[node] = load[node] if mem_free[node] >= thr else np.inf
    return mapping


@dataclass
class GreedyAdmission:
    """Outcome of GreedyP / GreedyPM admission of one incoming job."""

    mapping: Optional[List[int]]                 # for the incoming job
    paused: List[int] = field(default_factory=list)     # jids paused
    moved: Dict[int, List[int]] = field(default_factory=dict)  # jid -> new map


def _can_place(pool: NodePool, spec: JobSpec) -> bool:
    probe = greedy_place(pool, spec)
    if probe is None:
        return False
    pool.remove(spec, probe)
    return True


def greedy_p(
    pool: NodePool,
    spec: JobSpec,
    running: Sequence[JobView],
    now: float,
) -> GreedyAdmission:
    """GreedyP admission (§4.2): force-admit ``spec`` by pausing running jobs.

    ``running`` — running jobs, candidates for pausing.  ``pool`` is updated
    to the post-admission state when admission succeeds.
    """
    direct = greedy_place(pool, spec)
    if direct is not None:
        return GreedyAdmission(mapping=direct)

    by_prio = sorted(running, key=lambda js: js.priority_key(now))  # increasing
    # Phase 1: mark by increasing priority until the incoming job fits.
    marked: List[JobView] = []
    fits = False
    for js in by_prio:
        pool.remove(js.spec, js.mapping)
        marked.append(js)
        if _can_place(pool, spec):
            fits = True
            break
    if not fits:
        for js in marked:            # roll back
            pool.place(js.spec, js.mapping)
        return GreedyAdmission(mapping=None)
    # Phase 2: unmark in decreasing priority order when memory allows.
    unmarked: set = set()
    for js in sorted(marked, key=lambda j: j.priority_key(now), reverse=True):
        pool.place(js.spec, js.mapping)      # tentatively keep it running
        if _can_place(pool, spec):
            unmarked.add(js.spec.jid)
        else:
            pool.remove(js.spec, js.mapping)  # must stay paused
    mapping = greedy_place(pool, spec)
    if mapping is None:
        raise RuntimeError("GreedyP admission lost its verified placement")
    return GreedyAdmission(
        mapping=mapping,
        paused=[js.spec.jid for js in marked if js.spec.jid not in unmarked],
    )


def greedy_pm(
    pool: NodePool,
    spec: JobSpec,
    running: Sequence[JobView],
    now: float,
) -> GreedyAdmission:
    """GreedyPM (§4.2): as GreedyP, but victims are re-placed with Greedy
    (migrated) when possible instead of paused."""
    adm = greedy_p(pool, spec, running, now)
    if adm.mapping is None or not adm.paused:
        return adm
    by_jid = {js.spec.jid: js for js in running}
    still_paused: List[int] = []
    moved: Dict[int, List[int]] = {}
    # Re-place victims in decreasing priority order (§4.2: "in order of
    # their priority").
    victims = sorted(
        (by_jid[jid] for jid in adm.paused),
        key=lambda js: js.priority_key(now),
        reverse=True,
    )
    for js in victims:
        new_map = greedy_place(pool, js.spec)
        if new_map is None:
            still_paused.append(js.spec.jid)
        else:
            moved[js.spec.jid] = new_map
    adm.paused = still_paused
    adm.moved = moved
    return adm
