"""Pre-vectorization reference implementations of the allocation hot path.

These are the original pure-Python/dict-loop implementations of the §4.6
yield allocation, the §4.2 greedy placement and the §4.3 MCB8 packing
core, a copy of the JAX package's oracle that keeps its arithmetic
verbatim, for the vectorized kernels in
:mod:`repro_torch.core.alloc_kernels` and the device path above them:

* tests drive seeded specs/mappings through both paths and require
  bit-identical outputs;
* :func:`repro_torch.core.alloc_kernels.reference_kernels` switches the
  whole engine onto these implementations (ahead of any ``alloc_backend``)
  so end-to-end tests can compare full ``SimResult``s against the
  vectorized hot path and the device path.

Do not "improve" this module — its value is that it does not change.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from .job import JobSpec, NodePool

__all__ = [
    "node_tables",
    "maxmin_yields",
    "avg_yields",
    "greedy_place",
    "pack_core",
    "node_usage",
    "improve_max_stretch",
    "improve_avg_stretch",
]

_EPS = 1e-12


# --------------------------------------------------------------------------- #
# §4.6 yield allocation (original yield_alloc.py)                              #
# --------------------------------------------------------------------------- #
def node_tables(
    specs: Sequence[JobSpec], mappings: Sequence[Sequence[int]], n_nodes: int
) -> Tuple[np.ndarray, List[List[Tuple[int, int]]]]:
    """Return (per-node total CPU need, per-node list of (job_idx, mult))."""
    per_node: List[Dict[int, int]] = [dict() for _ in range(n_nodes)]
    for ji, mapping in enumerate(mappings):
        for node in mapping:
            per_node[node][ji] = per_node[node].get(ji, 0) + 1
    node_lists = [sorted(d.items()) for d in per_node]
    need = np.zeros(n_nodes)
    for node, items in enumerate(node_lists):
        need[node] = sum(specs[ji].cpu_need * mult for ji, mult in items)
    return need, node_lists


def maxmin_yields(
    specs: Sequence[JobSpec],
    mappings: Sequence[Sequence[int]],
    n_nodes: int,
) -> np.ndarray:
    """OPT=MIN reference: nested-loop water-filling."""
    m = len(specs)
    y = np.zeros(m)
    if m == 0:
        return y
    frozen = np.zeros(m, dtype=bool)
    load_need, node_lists = node_tables(specs, mappings, n_nodes)

    for _ in range(m + 1):
        if frozen.all():
            break
        best_level = 1.0  # cap at yield 1
        binding_nodes: List[int] = []
        for node, items in enumerate(node_lists):
            f_use = 0.0
            u_need = 0.0
            for ji, mult in items:
                c = specs[ji].cpu_need * mult
                if frozen[ji]:
                    f_use += y[ji] * c
                else:
                    u_need += c
            if u_need <= _EPS:
                continue
            level = max(0.0, (1.0 - f_use)) / u_need
            if level < best_level - 1e-15:
                best_level = level
                binding_nodes = [node]
            elif abs(level - best_level) <= 1e-15:
                binding_nodes.append(node)
        newly = np.zeros(m, dtype=bool)
        if best_level >= 1.0 - 1e-12:
            best_level = 1.0
            newly |= ~frozen  # everyone capped
        else:
            for node in binding_nodes:
                for ji, _ in node_lists[node]:
                    if not frozen[ji]:
                        newly[ji] = True
        y[~frozen] = best_level
        if not newly.any():          # numerical safety
            newly |= ~frozen
        frozen |= newly
    return np.clip(y, 0.0, 1.0)


def avg_yields(
    specs: Sequence[JobSpec],
    mappings: Sequence[Sequence[int]],
    n_nodes: int,
) -> np.ndarray:
    """OPT=AVG reference: LP (2) with a lil_matrix-built constraint matrix."""
    from scipy.optimize import linprog
    from scipy.sparse import lil_matrix

    m = len(specs)
    if m == 0:
        return np.zeros(0)
    load_need, node_lists = node_tables(specs, mappings, n_nodes)
    lam = float(load_need.max()) if n_nodes else 0.0
    y_min = 1.0 / max(1.0, lam)
    a = lil_matrix((n_nodes, m))
    for node, items in enumerate(node_lists):
        for ji, mult in items:
            a[node, ji] = specs[ji].cpu_need * mult
    res = linprog(
        c=-np.ones(m),
        A_ub=a.tocsr(),
        b_ub=np.ones(n_nodes),
        bounds=[(y_min, 1.0)] * m,
        method="highs",
    )
    if not res.success:  # numerically degenerate: fall back to the safe floor
        return np.full(m, y_min)
    return np.clip(res.x, 0.0, 1.0)


# --------------------------------------------------------------------------- #
# §4.2 greedy placement (original greedy.py)                                   #
# --------------------------------------------------------------------------- #
def greedy_place(pool: NodePool, spec: JobSpec) -> Optional[List[int]]:
    """Per-task argmin over a freshly rebuilt masked-load array."""
    mapping: List[int] = []
    for _ in range(spec.n_tasks):
        feasible = pool.mem_free >= spec.mem_req - 1e-12
        if not feasible.any():
            if mapping:
                pool.remove(spec, mapping)
            return None
        loads = np.where(feasible, pool.load, np.inf)
        node = int(np.argmin(loads))
        mapping.append(node)
        pool.load[node] += spec.cpu_need
        pool.mem_free[node] -= spec.mem_req
    return mapping


# --------------------------------------------------------------------------- #
# §4.3 MCB8 packing core (original mcb8.py)                                    #
# --------------------------------------------------------------------------- #
_PACK_EPS = 1e-9


def _sorted_arrays(entries):
    entries = sorted(entries, key=lambda e: (-max(e[1], e[2]), e[0]))
    jid = np.array([e[0] for e in entries], dtype=np.int64)
    cpu = np.array([e[1] for e in entries])
    mem = np.array([e[2] for e in entries])
    left = np.array([e[3] for e in entries], dtype=np.int64)
    return jid, cpu, mem, left


def pack_core(n_nodes, jobs, pre_placed, cpu_free, mem_free, out):
    """One MCB8 pack over ``jobs`` = [(jid, cpu_req, mem_req, n_tasks)]."""
    lists = [
        _sorted_arrays([e for e in jobs if e[1] > e[2]]),    # CPU-intensive
        _sorted_arrays([e for e in jobs if e[1] <= e[2]]),   # memory-intensive
    ]
    for e in jobs:
        out.setdefault(int(e[0]), [])

    def take_from(li: int, node: int, prefer_mem: bool) -> int:
        jid, cpu, mem, left = lists[li]
        if jid.size == 0:
            return 0
        cf, mf = cpu_free[node], mem_free[node]
        ok = (left > 0) & (cpu <= cf + _PACK_EPS) & (mem <= mf + _PACK_EPS)
        i = int(np.argmax(ok))
        if not ok[i]:
            return 0
        k = int(left[i])
        if cpu[i] > _PACK_EPS:
            k = min(k, int((cf + _PACK_EPS) / cpu[i]))
        if mem[i] > _PACK_EPS:
            k = min(k, int((mf + _PACK_EPS) / mem[i]))
        d0 = mf - cf
        delta = mem[i] - cpu[i]
        if prefer_mem and delta > _PACK_EPS:          # d must stay > 0
            k = min(k, max(1, int(np.ceil((d0 - _PACK_EPS) / delta))))
        elif not prefer_mem and delta < -_PACK_EPS:   # d must stay <= 0
            k = min(k, max(1, int(np.ceil((d0 + _PACK_EPS) / delta))))
        k = max(k, 1)
        left[i] -= k
        cpu_free[node] -= k * cpu[i]
        mem_free[node] -= k * mem[i]
        out[int(jid[i])].extend([node] * k)
        return k

    remaining = int(lists[0][3].sum() + lists[1][3].sum())
    for node in range(n_nodes):
        while remaining > 0:
            prefer_mem = bool(mem_free[node] > cpu_free[node])
            first, second = (1, 0) if prefer_mem else (0, 1)
            placed = take_from(first, node, prefer_mem) or take_from(second, node, prefer_mem)
            if placed:
                remaining -= placed
            else:
                break
        if remaining == 0:
            break
    if remaining > 0:
        return None
    out.update(pre_placed)
    return out


# --------------------------------------------------------------------------- #
# §4.7 stretch post-passes (original stretch_opt.py internals)                 #
# --------------------------------------------------------------------------- #
def node_usage(jobs, mappings, yields, n_nodes):
    use = np.zeros(n_nodes)
    for js in jobs:
        for node in mappings[js.spec.jid]:
            use[node] += yields[js.spec.jid] * js.spec.cpu_need
    return use


def _required_yield(js, now: float, period: float, target: float) -> float:
    ft = js.flow_time(now)
    return ((ft + period) / target - js.vt) / period


def improve_max_stretch(
    jobs,
    mappings: Dict[int, List[int]],
    yields: Dict[int, float],
    n_nodes: int,
    now: float,
    period: float,
    max_rounds: int = 200,
) -> Dict[int, float]:
    """OPT=MAX reference: per-round Python loops over jobs and node usage."""
    jobs = [js for js in jobs if js.spec.jid in mappings]
    if not jobs:
        return yields
    yields = dict(yields)
    frozen: set = set()

    def est(js):
        return (js.flow_time(now) + period) / max(
            _PACK_EPS, js.vt + yields[js.spec.jid] * period)

    for _ in range(max_rounds):
        live = [js for js in jobs
                if js.spec.jid not in frozen
                and yields[js.spec.jid] < 1.0 - _PACK_EPS]
        if not live:
            break
        worst = max(live, key=est)
        s_worst = est(worst)
        others = [est(js) for js in jobs if js is not worst]
        s_next = max([s for s in others if s < s_worst - 1e-12], default=1.0)
        target = max(s_next, 1.0)
        y_target = _required_yield(worst, now, period, target)
        use = node_usage(jobs, mappings, yields, n_nodes)
        jid = worst.spec.jid
        mult: Dict[int, int] = {}
        for node in mappings[jid]:
            mult[node] = mult.get(node, 0) + 1
        dy_slack = min(
            (1.0 - use[node]) / (worst.spec.cpu_need * k) for node, k in mult.items()
        )
        dy = min(max(0.0, y_target - yields[jid]), max(0.0, dy_slack),
                 1.0 - yields[jid])
        if dy <= 1e-6:
            frozen.add(jid)
            continue
        yields[jid] += dy
    return yields


def improve_avg_stretch(
    jobs,
    mappings: Dict[int, List[int]],
    yields: Dict[int, float],
    n_nodes: int,
    now: float,
    period: float,
) -> Dict[int, float]:
    """OPT=AVG reference: lil_matrix-built LP."""
    from scipy.optimize import linprog
    from scipy.sparse import lil_matrix

    jobs = [js for js in jobs if js.spec.jid in mappings]
    if not jobs:
        return yields
    m = len(jobs)
    a = lil_matrix((n_nodes, m))
    lo = np.zeros(m)
    w = np.zeros(m)
    for i, js in enumerate(jobs):
        for node in mappings[js.spec.jid]:
            a[node, i] += js.spec.cpu_need
        lo[i] = yields[js.spec.jid]
        w[i] = period / (js.flow_time(now) + period)
    res = linprog(
        c=-w,
        A_ub=a.tocsr(),
        b_ub=np.ones(n_nodes),
        bounds=list(zip(lo, np.ones(m))),
        method="highs",
    )
    out = dict(yields)
    if res.success:
        for i, js in enumerate(jobs):
            out[js.spec.jid] = float(np.clip(res.x[i], 0.0, 1.0))
    return out
