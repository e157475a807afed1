"""Accelerator job types from dry-run roofline records: the ``tpu`` workload.

The bridge between a model's roofline and the scheduler: every
(architecture × input shape) record of a dry run (compute, memory and
collective seconds a step, bytes a device) becomes a DFRS *job type* whose

* ``cpu_need``  = compute_term / max(compute, memory, collective) — the
  fraction of a node's compute the step can actually use (a
  bandwidth-bound decode step cannot saturate it, exactly the
  fractional-use phenomenon DFRS exploits);
* ``mem_req``   = bytes_per_device / HBM_BYTES — a hard constraint, like the
  paper's no-swap rule;
* ``n_tasks``   = the number of devices the job's mesh spans (scaled down
  by ``chips_per_task`` when simulating at slice granularity).

``tpu_trace`` samples a Poisson mixture over job types to produce a cluster
workload for the scheduler.  The records (``arch``, ``shape``,
``compute_s``, ``memory_s``, ``collective_s``, ``bytes_per_device``,
``n_chips``) come from a dry run: this package's own
(``python -m repro_torch.launch.dryrun``, turned into these records by
``repro_torch.launch.roofline.jobgen_records``), or the JAX package's,
which writes the same format.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Sequence

import numpy as np

from ..core.job import JobSpec

__all__ = ["TpuJobType", "tpu_job_types", "tpu_trace", "HBM_BYTES",
           "DEFAULT_TPU_JOB_TYPES"]

#: memory of one node of the *simulated* cluster (16 GiB, the job model's
#: accelerator node), against which a record's bytes a device become
#: ``mem_req``.  It defines the workload — the same records must give the
#: same trace in every program that reads them — and is not a property of
#: the device this package runs on.
HBM_BYTES = 16 * 1024**3


@dataclass(frozen=True)
class TpuJobType:
    name: str
    cpu_need: float
    mem_req: float
    n_tasks: int
    typical_duration: float    # s; e.g. a training run segment / serve session


def tpu_job_types(
    roofline_records: Sequence[dict],
    chips_per_task: int = 16,
    duration_per_step_mult: float = 2_000.0,
) -> List[TpuJobType]:
    """Derive job types from dry-run roofline records."""
    out: List[TpuJobType] = []
    for rec in roofline_records:
        terms = [rec["compute_s"], rec["memory_s"], rec["collective_s"]]
        dom = max(terms)
        if dom <= 0:
            continue
        cpu_need = float(np.clip(rec["compute_s"] / dom, 0.01, 1.0))
        mem_req = float(np.clip(rec["bytes_per_device"] / HBM_BYTES, 0.01, 1.0))
        chips = int(rec.get("n_chips", 256))
        n_tasks = max(1, chips // chips_per_task)
        dur = max(60.0, dom * duration_per_step_mult)
        out.append(
            TpuJobType(
                name=f"{rec['arch']}:{rec['shape']}",
                cpu_need=cpu_need,
                mem_req=mem_req,
                n_tasks=n_tasks,
                typical_duration=dur,
            )
        )
    return out


#: Deterministic job-type mix of the ``tpu`` workload kind when no roofline
#: records are given: values follow the derivation of ``tpu_job_types``
#: (cpu_need = compute fraction of the dominant roofline term, mem_req =
#: memory footprint fraction) for archetypal cells — a compute-bound
#: trainer, a mid-size fine-tune, a bandwidth-bound decode server (the
#: fractional-use case DFRS exploits) and a prefill burst.
DEFAULT_TPU_JOB_TYPES = (
    TpuJobType("trainer-large", cpu_need=0.92, mem_req=0.78, n_tasks=16,
               typical_duration=14_400.0),
    TpuJobType("finetune-mid", cpu_need=0.85, mem_req=0.45, n_tasks=4,
               typical_duration=3_600.0),
    TpuJobType("serve-decode", cpu_need=0.18, mem_req=0.62, n_tasks=2,
               typical_duration=1_800.0),
    TpuJobType("serve-prefill", cpu_need=0.70, mem_req=0.30, n_tasks=1,
               typical_duration=600.0),
)


def tpu_trace(
    job_types: Sequence[TpuJobType],
    n_jobs: int = 200,
    n_nodes: int = 128,
    seed: int = 0,
    target_load: float = 0.6,
) -> List[JobSpec]:
    """Poisson mixture over job types at a target offered load."""
    rng = np.random.default_rng(seed)
    types = [t for t in job_types if t.n_tasks <= n_nodes]
    if not types:
        raise ValueError("no job types fit the cluster")
    probs = np.ones(len(types)) / len(types)
    # expected work per job → arrival rate for the target load
    e_work = float(
        np.sum([p * t.n_tasks * t.cpu_need * t.typical_duration for p, t in zip(probs, types)])
    )
    mean_gap = e_work / (target_load * n_nodes)
    specs: List[JobSpec] = []
    t = 0.0
    for jid in range(n_jobs):
        t += float(rng.exponential(mean_gap))
        jt = types[int(rng.choice(len(types), p=probs))]
        dur = float(jt.typical_duration * rng.lognormal(0.0, 0.5))
        specs.append(
            JobSpec(
                jid=jid, release=t, proc_time=max(30.0, dur),
                n_tasks=jt.n_tasks, cpu_need=jt.cpu_need, mem_req=jt.mem_req,
            )
        )
    return specs
