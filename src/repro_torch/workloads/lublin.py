"""Lublin–Feitelson synthetic workload model (paper §5.3.2).

Follows Lublin & Feitelson (JPDC 2003) for job sizes (two-stage log-uniform
with power-of-two rounding) and runtimes (hyper-gamma on log2 runtime whose
short/long mixture probability depends linearly on job size), with a
daily-cycle-modulated Poisson arrival process.  The paper's §5.3.2
augmentation is applied on top:

* quad-core nodes — a one-task job is sequential (CPU need 0.25), every task
  of a multi-task job is multi-threaded and CPU-bound (need 1.0);
* memory (Setia et al. model): 55 % of jobs need 10 % of node memory, the
  rest need 10·x % with x uniform over {2..10}.

``scale_to_load`` multiplies inter-arrival times by a computed constant so a
trace realizes a target offered load, reproducing the paper's 9 scaled
variants (0.1..0.9) per base trace.
"""
from __future__ import annotations

from typing import List, Sequence

import numpy as np

from ..core.job import JobSpec

__all__ = ["lublin_trace", "offered_load", "scale_to_load"]

# Lublin-Feitelson batch-job constants
_SERIAL_PROB = 0.244
_POW2_PROB = 0.78
_ULOW, _UMED, _UPROB = 0.8, 4.5, 0.86
# hyper-gamma on log2(runtime):  short ~ Gamma(4.2, 0.94), long ~ Gamma(312, 0.03)
_A1, _B1 = 4.2, 0.94
_A2, _B2 = 312.0, 0.03
_PA, _PB = -0.0054, 0.78
_MEAN_INTERARRIVAL = 450.0   # s; gives the paper's ~4-6 day span for 1000 jobs
_RUNTIME_CAP = 6 * 86400.0


def _two_stage_uniform(rng, lo, med, hi, prob):
    if rng.random() <= prob:
        return rng.uniform(lo, med)
    return rng.uniform(med, hi)


def _job_size(rng, n_nodes: int) -> int:
    if rng.random() < _SERIAL_PROB:
        return 1
    uhi = np.log2(n_nodes)
    # Lublin's defaults (uMed=4.5) assume uHi=log2(128)=7, i.e. uMed=uHi-2.5;
    # keep that offset for smaller clusters so uLow <= uMed <= uHi.
    umed = min(_UMED, max(_ULOW, uhi - 2.5))
    u = _two_stage_uniform(rng, _ULOW, umed, uhi, _UPROB)
    if rng.random() <= _POW2_PROB:
        size = 2 ** int(round(u))
    else:
        size = int(round(2**u))
    return int(np.clip(size, 1, n_nodes))


def _runtime(rng, size: int) -> float:
    p = float(np.clip(_PA * size + _PB, 0.0, 1.0))
    if rng.random() <= p:
        lg = rng.gamma(_A1, _B1)
    else:
        lg = rng.gamma(_A2, _B2)
    return float(np.clip(2.0**lg, 1.0, _RUNTIME_CAP))


def lublin_trace(
    n_jobs: int = 1000,
    n_nodes: int = 128,
    seed: int = 0,
    mean_interarrival: float = _MEAN_INTERARRIVAL,
    daily_cycle: bool = True,
) -> List[JobSpec]:
    rng = np.random.default_rng(seed)
    specs: List[JobSpec] = []
    t = 0.0
    for jid in range(n_jobs):
        gap = rng.exponential(mean_interarrival)
        if daily_cycle:
            # rush-hour modulation: rate peaks mid-day
            phase = 2 * np.pi * ((t / 86400.0) % 1.0)
            gap *= 1.0 / (1.0 + 0.6 * np.sin(phase - np.pi / 2) + 0.6)
        t += float(gap)
        size = _job_size(rng, n_nodes)
        proc = _runtime(rng, size)
        cpu_need = 0.25 if size == 1 else 1.0
        if rng.random() < 0.55:
            mem = 0.10
        else:
            mem = 0.10 * int(rng.integers(2, 11))
        specs.append(
            JobSpec(
                jid=jid, release=t, proc_time=proc,
                n_tasks=size, cpu_need=cpu_need, mem_req=float(mem),
            )
        )
    return specs


def offered_load(specs: Sequence[JobSpec], n_nodes: int) -> float:
    """Total CPU work over cluster capacity x trace span ([3]'s offered load)."""
    if not specs:
        return 0.0
    work = sum(s.total_work for s in specs)
    span = max(s.release for s in specs) - min(s.release for s in specs)
    span = max(span, 1.0)
    return work / (n_nodes * span)


def scale_to_load(
    specs: Sequence[JobSpec], n_nodes: int, target_load: float
) -> List[JobSpec]:
    """Multiply inter-arrival times by a constant to hit ``target_load``."""
    base = offered_load(specs, n_nodes)
    factor = base / target_load
    t0 = min(s.release for s in specs)
    out = []
    for s in sorted(specs, key=lambda s: s.release):
        out.append(
            JobSpec(
                jid=s.jid,
                release=t0 + (s.release - t0) * factor,
                proc_time=s.proc_time,
                n_tasks=s.n_tasks,
                cpu_need=s.cpu_need,
                mem_req=s.mem_req,
            )
        )
    return out
