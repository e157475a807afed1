"""MCB8 — two-dimensional vector-packing resource allocation (paper §4.3).

Fixing a target yield Y turns fluid CPU needs into CPU *requirements*
(c_j * Y); the mapping problem then becomes 2-D vector packing (CPU, memory)
which we solve with the Leinberger-style multi-capacity heuristic the paper
calls MCB8: two lists (CPU-intensive / memory-intensive), each sorted by
non-increasing largest requirement, packing always drawing from the list
that goes against the current node imbalance.

A binary search (accuracy 0.01) finds the largest feasible Y.  If no Y is
feasible (memory-infeasible), the lowest-priority job is removed from
consideration and the search restarts (§4.3).

``pinned`` mappings support the MINVT/MINFT grace parameters: a pinned job,
if it keeps running, must keep its current node mapping — it is pre-placed
before the two-list packing fills the remainder.

Hot-path implementation notes (the float operation order, sort keys and
iteration order are part of the result: every decision turns on a float
comparison against ``_EPS``):

* Each list is sorted by non-increasing *dominant* requirement, so the
  dominant-axis feasibility test is a contiguous suffix found by bisection
  instead of a whole-array boolean scan per placement.
* Within that suffix, exhausted items are skipped through a path-compressed
  "next alive" union-find, and the *fallback* list never needs its secondary
  requirement checked at all: when memory is the node's scarcer axis the
  CPU-intensive item that fits on CPU automatically fits in memory (its
  memory need is below its CPU need, which is below the CPU slack, which is
  below the memory slack), and symmetrically for the other direction.  Only
  the *preferred* list pays a secondary scan, and that scan vectorizes after
  a few misses.
* A conservative aggregate capacity pre-check (total requirement vs. total
  free capacity plus the maximum possible epsilon over-consumption) rejects
  hopeless probes before packing a single task — the binary search probes
  infeasibly-high yields about half the time.
"""
from __future__ import annotations

import math
from bisect import bisect_left
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from . import alloc_kernels, alloc_reference

__all__ = ["MCB8Result", "mcb8_pack", "mcb8"]

_EPS = 1e-9
Y_FLOOR = 0.01  # smallest yield probed; also the binary-search accuracy


@dataclass
class MCB8Result:
    mappings: Dict[int, List[int]]   # jid -> node per task (scheduled jobs)
    yld: float                       # achieved uniform target yield
    removed: List[int]               # jids dropped from consideration


# --------------------------------------------------------------------------- #
# packing core                                                                 #
# --------------------------------------------------------------------------- #
class _PackList:
    """One MCB8 list: items sorted by non-increasing dominant requirement.

    ``prim`` is the dominant axis (CPU for the CPU-intensive list, memory
    for the memory-intensive list), ``sec`` the other one.  Plain Python
    lists carry the per-placement scalar reads; ``sec_np``/``left_np``
    mirror the columns the vectorized fallback scan needs.  ``nxt`` is the
    union-find "first alive index >= i" structure (items only ever die).
    """

    __slots__ = ("n", "jid", "prim", "sec", "cpu", "mem", "left",
                 "neg_prim", "sec_np", "left_np", "nxt")

    def __init__(self, jid, cpu, mem, left, primary_is_cpu: bool):
        maxv = np.maximum(cpu, mem)
        order = np.lexsort((jid, -maxv))   # == sorted by (-max req, jid)
        jid, cpu, mem = jid[order], cpu[order], mem[order]
        left = left[order]
        prim, sec = (cpu, mem) if primary_is_cpu else (mem, cpu)
        self.n = int(jid.shape[0])
        self.jid = jid.tolist()
        self.cpu = cpu.tolist()
        self.mem = mem.tolist()
        self.prim = prim.tolist()
        self.sec = sec.tolist()
        self.left = left.tolist()
        self.neg_prim = (-prim).tolist()   # ascending, for bisect
        self.sec_np = sec
        self.left_np = left.copy()
        self.nxt = list(range(self.n + 1))

    def first_alive(self, i: int) -> int:
        """Smallest alive index >= i (== n when none), path-compressed."""
        nxt = self.nxt
        j = i
        while nxt[j] != j:
            j = nxt[j]
        while nxt[i] != i:
            nxt[i], i = j, nxt[i]
        return j


def _pack_core(n_nodes, jid, cpu, mem, ntask, pre_placed, cpu_free, mem_free):
    """Fast MCB8 pack; items given as parallel arrays in candidate order."""
    cpu_mask = cpu > mem
    lists = [
        _PackList(jid[cpu_mask], cpu[cpu_mask], mem[cpu_mask],
                  ntask[cpu_mask], primary_is_cpu=True),
        _PackList(jid[~cpu_mask], cpu[~cpu_mask], mem[~cpu_mask],
                  ntask[~cpu_mask], primary_is_cpu=False),
    ]
    out: Dict[int, List[int]] = {int(j): [] for j in jid}

    remaining = int(ntask.sum())
    # Aggregate capacity bound: the heuristic can never consume more than
    # the positive free capacity plus one _EPS of tolerated overdraw per
    # placed batch and per node, so a total requirement beyond that bound is
    # a guaranteed (bit-identical) pack failure.  Checked up front and again
    # at every node boundary against the *suffix* capacity — nodes are
    # filled strictly in order and never revisited, so once the untouched
    # nodes cannot possibly host what is left, the pack is doomed and the
    # remaining per-node crawl (the bulk of an infeasible probe) is skipped.
    slack = (remaining + n_nodes) * 4e-9 + 1e-7
    req_cpu = float((cpu * ntask).sum())
    req_mem = float((mem * ntask).sum())
    # suffix[i] = free capacity of nodes i.. (clipped at 0 per node)
    cpu_suffix = np.append(
        np.cumsum(np.maximum(0.0, cpu_free)[::-1])[::-1], 0.0).tolist()
    mem_suffix = np.append(
        np.cumsum(np.maximum(0.0, mem_free)[::-1])[::-1], 0.0).tolist()
    if req_cpu > cpu_suffix[0] + slack or req_mem > mem_suffix[0] + slack:
        return None

    cf_l = cpu_free.tolist()
    mf_l = mem_free.tolist()

    def take_from(li: int, node: int, prefer_mem: bool, easy: bool) -> int:
        L = lists[li]
        n = L.n
        if n == 0:
            return 0
        cf = cf_l[node]
        mf = mf_l[node]
        if li == 0:
            p_lim, s_lim = cf + _EPS, mf + _EPS
        else:
            p_lim, s_lim = mf + _EPS, cf + _EPS
        s = bisect_left(L.neg_prim, -p_lim)   # first prim[i] <= p_lim
        i = L.first_alive(s)
        if not easy:
            sec = L.sec
            hops = 0
            while i < n and sec[i] > s_lim:
                i = L.first_alive(i + 1)
                hops += 1
                if hops >= 16 and i < n:      # vectorize the long tail
                    ok = (L.sec_np[i:] <= s_lim) & (L.left_np[i:] > 0)
                    j = int(ok.argmax())
                    i = i + j if ok[j] else n
                    break
        if i >= n:
            return 0
        cpu_i = L.cpu[i]
        mem_i = L.mem[i]
        k = L.left[i]
        if cpu_i > _EPS:
            k = min(k, int((cf + _EPS) / cpu_i))
        if mem_i > _EPS:
            k = min(k, int((mf + _EPS) / mem_i))
        # preference-flip cap: preference is evaluated before each placement;
        # d_s = (mf - cf) - s*(mem_i - cpu_i) must keep its sign for s<k.
        d0 = mf - cf
        delta = mem_i - cpu_i
        if prefer_mem and delta > _EPS:          # d must stay > 0
            k = min(k, max(1, math.ceil((d0 - _EPS) / delta)))
        elif not prefer_mem and delta < -_EPS:   # d must stay <= 0
            k = min(k, max(1, math.ceil((d0 + _EPS) / delta)))
        k = max(k, 1)
        left = L.left[i] - k
        L.left[i] = left
        L.left_np[i] = left
        if left == 0:
            L.nxt[i] = i + 1
        cf_l[node] = cf - k * cpu_i
        mf_l[node] = mf - k * mem_i
        nonlocal req_cpu, req_mem
        req_cpu -= k * cpu_i
        req_mem -= k * mem_i
        out[L.jid[i]].extend([node] * k)
        return k

    for node in range(n_nodes):
        while remaining > 0:
            # Go against the imbalance: if available memory exceeds available
            # CPU, consume memory first (pick a memory-intensive job).
            prefer_mem = mf_l[node] > cf_l[node]
            first, second = (1, 0) if prefer_mem else (0, 1)
            placed = (take_from(first, node, prefer_mem, easy=False)
                      or take_from(second, node, prefer_mem, easy=True))
            if placed:
                remaining -= placed
            else:
                break
        if remaining == 0:
            break
        # nodes 0..node are final now; if what is left cannot possibly fit
        # in the untouched suffix, the pack is already a guaranteed failure
        if (req_cpu > cpu_suffix[node + 1] + slack
                or req_mem > mem_suffix[node + 1] + slack):
            return None
    if remaining > 0:
        return None
    out.update(pre_placed)
    return out


def _try_pack(
    n_nodes: int,
    jid: np.ndarray,
    cpu: np.ndarray,
    mem: np.ndarray,
    ntask: np.ndarray,
    pinned_full: Dict[int, Tuple[float, float, List[int]]],
    alive: Optional[np.ndarray] = None,
) -> Optional[Dict[int, List[int]]]:
    """Pack with pinned jobs pre-placed.  pinned_full: jid -> (cpu_req,
    mem_req, mapping).  Items are parallel arrays in candidate order."""
    cpu_free = np.ones(n_nodes)
    mem_free = np.ones(n_nodes)
    if alive is not None:
        cpu_free[~alive] = -1.0
        mem_free[~alive] = -1.0
    pre: Dict[int, List[int]] = {}
    for pj, (cpu_req, mem_req, mapping) in pinned_full.items():
        for node in mapping:
            cpu_free[node] -= cpu_req
            mem_free[node] -= mem_req
        pre[pj] = list(mapping)
    if (cpu_free < -_EPS).any() or (mem_free < -_EPS).any():
        return None
    if alloc_kernels.reference_kernels_active():
        jobs = list(zip(jid.tolist(), cpu.tolist(), mem.tolist(),
                        ntask.tolist()))
        return alloc_reference.pack_core(n_nodes, jobs, pre,
                                         cpu_free, mem_free, {})
    return _pack_core(n_nodes, jid, cpu, mem, ntask, pre, cpu_free, mem_free)


def mcb8_pack(
    n_nodes: int,
    jobs: Sequence[Tuple[int, float, float, int]],  # (jid, cpu_req, mem_req, n_tasks)
) -> Optional[Dict[int, List[int]]]:
    """One shot of the MCB8 packing heuristic.  Returns jid->mapping or None."""
    jid = np.array([e[0] for e in jobs], dtype=np.int64)
    cpu = np.array([e[1] for e in jobs], dtype=np.float64)
    mem = np.array([e[2] for e in jobs], dtype=np.float64)
    ntask = np.array([e[3] for e in jobs], dtype=np.int64)
    return _try_pack(n_nodes, jid, cpu, mem, ntask, {})


# --------------------------------------------------------------------------- #
# full MCB8 allocation                                                         #
# --------------------------------------------------------------------------- #
class _Candidates:
    """Per-call arrays over the priority-sorted candidate set; a probe with
    per-candidate CPU requirements and suffix start k materializes items
    without touching the job objects again.  Shared by plain MCB8
    (requirements = yield-scaled needs) and MCB8-stretch (requirements
    derived from the stretch target)."""

    __slots__ = ("states", "jid", "cpu", "mem", "ntask", "pin_mask", "pinned")

    def __init__(self, active: Sequence, pinned: Dict[int, List[int]]):
        self.states = active
        self.jid = np.array([js.spec.jid for js in active], dtype=np.int64)
        self.cpu = np.array([js.spec.cpu_need for js in active])
        self.mem = np.array([js.spec.mem_req for js in active])
        self.ntask = np.array([js.spec.n_tasks for js in active], dtype=np.int64)
        self.pin_mask = np.array([js.spec.jid in pinned for js in active],
                                 dtype=bool)
        self.pinned = pinned

    def pack_probe(self, cpu_req: np.ndarray, k: int, n_nodes: int,
                   alive: Optional[np.ndarray]):
        """Pack candidates[k:] with ``cpu_req`` aligned to that suffix."""
        pin = self.pin_mask[k:]
        pins: Dict[int, Tuple[float, float, List[int]]] = {}
        for i in np.nonzero(pin)[0].tolist():
            j = int(self.jid[k + i])
            pins[j] = (float(cpu_req[i]), float(self.mem[k + i]), self.pinned[j])
        free = ~pin
        return _try_pack(
            n_nodes,
            self.jid[k:][free], cpu_req[free],
            self.mem[k:][free], self.ntask[k:][free],
            pins, alive,
        )

    def probe(self, y: float, k: int, n_nodes: int,
              alive: Optional[np.ndarray]):
        """Feasibility of uniform yield ``y`` for candidates[k:]."""
        return self.pack_probe(np.minimum(1.0, self.cpu[k:] * y),
                               k, n_nodes, alive)


def mcb8(
    candidates: Sequence,
    n_nodes: int,
    now: float,
    pinned: Optional[Dict[int, List[int]]] = None,
    accuracy: float = Y_FLOOR,
    alive: Optional[np.ndarray] = None,
) -> MCB8Result:
    """Full MCB8 allocation: binary search on yield + low-priority removal.

    ``candidates`` are job views (:class:`~repro_torch.core.state.JobView`
    or any object with ``.spec``, ``.vt``, ``flow_time(now)`` and
    ``priority_key(now)``)."""
    pinned = dict(pinned or {})
    active = sorted(candidates, key=lambda js: js.priority_key(now))  # incr prio
    removed: List[int] = []
    cand = _Candidates(active, pinned)

    def feasible(y: float, k: int):
        return cand.probe(y, k, n_nodes, alive)

    # Removal loop (§4.3): drop the lowest-priority job and retry until the
    # remainder fits at the smallest probed yield.  Feasibility is monotone
    # in the number of removals, so the smallest feasible removal count is
    # found by bisection — identical outcome to one-at-a-time removal.
    k0 = 0
    base = feasible(accuracy, k0)
    if base is None:
        lo_r, hi_r = 0, len(active)          # lo_r infeasible; hi_r feasible
        if feasible(accuracy, len(active)) is None:  # not even the pinned fit
            return MCB8Result({}, 0.0, [js.spec.jid for js in active])
        while hi_r - lo_r > 1:
            mid = (lo_r + hi_r) // 2
            if feasible(accuracy, mid) is None:
                lo_r = mid
            else:
                hi_r = mid
        removed = [js.spec.jid for js in active[:hi_r]]
        k0 = hi_r
        base = feasible(accuracy, k0)
        assert base is not None

    if k0 >= len(active):
        return MCB8Result({}, 0.0, removed)
    best_map, best_y = base, accuracy
    full = feasible(1.0, k0)
    if full is not None:
        return MCB8Result(full, 1.0, removed)
    lo, hi = accuracy, 1.0
    while hi - lo > accuracy:
        mid = 0.5 * (lo + hi)
        pack = feasible(mid, k0)
        if pack is not None:
            best_map, best_y, lo = pack, mid, mid
        else:
            hi = mid
    return MCB8Result(best_map, best_y, removed)
