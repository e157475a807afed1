"""HPC2N real-world trace handling (paper §5.3.1).

The paper uses the cleaned HPC2N log from the Parallel Workloads Archive
(182 weeks, 120 dual-core 2 GB nodes).  ``parse_swf`` reads the standard swf
format; ``hpc2n_preprocess`` applies the paper's §5.3.1 transformation:

* per-processor memory = max(requested, used) / 2 GB, floored at 10 %;
* jobs with an even processor count and < 50 % per-processor memory are
  assumed multi-threaded: tasks = procs / 2, CPU need 1.0 (saturates both
  cores), memory doubled;
* otherwise: tasks = procs, CPU need 0.5 (one core), memory unchanged.

The archive is not redistributable with the repo, so ``hpc2n_like_trace``
synthesizes swf rows with the trace's published marginals (job sizes heavy
at small powers of two, > 95 % of jobs under 40 % memory, runtimes
seconds→days) and runs them through the *same* preprocessing.  A real log
enters through the ``swf`` workload kind
(``repro_torch.workloads.registry.parse_workload("swf:<path>")``).
"""
from __future__ import annotations

import io
from typing import List, Optional, Sequence

import numpy as np

from ..core.job import JobSpec

__all__ = ["parse_swf", "iter_swf", "iter_swf_windows", "hpc2n_preprocess",
           "hpc2n_like_trace", "SwfJob", "NODE_MEM_GB", "N_NODES"]

NODE_MEM_GB = 2.0
N_NODES = 120


class SwfJob:
    __slots__ = ("jid", "submit", "run", "procs", "used_mem_kb", "req_mem_kb")

    def __init__(self, jid, submit, run, procs, used_mem_kb, req_mem_kb):
        self.jid = jid
        self.submit = submit
        self.run = run
        self.procs = procs
        self.used_mem_kb = used_mem_kb
        self.req_mem_kb = req_mem_kb


def iter_swf(text_or_path):
    """Lazily yield :class:`SwfJob` rows from an swf log (same skip rules
    as :func:`parse_swf`; never holds more than one line in memory)."""
    if isinstance(text_or_path, str) and "\n" not in text_or_path:
        fh = open(text_or_path)
    else:
        fh = io.StringIO(text_or_path)
    with fh:
        for line in fh:
            line = line.strip()
            if not line or line.startswith(";"):
                continue
            f = line.split()
            if len(f) < 11:
                continue
            jid = int(f[0]); submit = float(f[1]); run = float(f[3])
            procs = int(f[4]); used_mem = float(f[6])
            req_mem = float(f[9])
            if run <= 0 or procs <= 0:
                continue
            yield SwfJob(jid, submit, run, procs, used_mem, req_mem)


def parse_swf(text_or_path) -> List[SwfJob]:
    """Parse the Standard Workload Format (fields per swf spec; -1 = n/a)."""
    return list(iter_swf(text_or_path))


def hpc2n_preprocess(swf_jobs: Sequence[SwfJob],
                     start_jid: int = 0) -> List[JobSpec]:
    """§5.3.1 transformation of swf rows into DFRS job specs.

    jids are re-assigned contiguously in submit order, from ``start_jid``:
    a chunked caller (:func:`iter_swf_windows`) continues the numbering of
    an earlier chunk and reproduces exactly the jids a whole-log pass
    assigns.
    """
    specs: List[JobSpec] = []
    node_kb = NODE_MEM_GB * 1024 * 1024
    for k, j in enumerate(sorted(swf_jobs, key=lambda j: j.submit),
                          start=start_jid):
        per_proc = max(j.used_mem_kb, j.req_mem_kb)
        mem_frac = max(0.10, per_proc / node_kb) if per_proc > 0 else 0.10
        mem_frac = min(1.0, mem_frac)
        if j.procs % 2 == 0 and mem_frac < 0.5:
            n_tasks = j.procs // 2
            cpu_need = 1.0
            mem = min(1.0, 2 * mem_frac)
        else:
            n_tasks = j.procs
            cpu_need = 0.5
            mem = mem_frac
        specs.append(
            JobSpec(
                jid=k, release=float(j.submit), proc_time=float(j.run),
                n_tasks=n_tasks, cpu_need=cpu_need, mem_req=mem,
            )
        )
    return specs


def iter_swf_windows(text_or_path, window_s: float, n_jobs: int = 0):
    """Stream an swf log as per-release-window ``List[JobSpec]`` chunks.

    Reads the log line by line (never materializing it) and yields the
    §5.3.1-preprocessed specs of each half-open submit-time window
    ``[lo + k*window_s, lo + (k+1)*window_s)`` anchored at the first
    accepted row's submit time; empty windows are skipped.  ``n_jobs``
    caps the number of rows taken (0 = the whole log), counted *before*
    any downstream width filter — the same prefix semantics as the
    materialized ``swf`` workload kind.

    Because jids are re-assigned in submit order, the log must already be
    sorted by submit time (true of the cleaned Parallel Workloads Archive
    logs).  An out-of-order row raises — use the materialized
    ``swf:<path>`` kind for unsorted logs.

    Concatenating the chunks reproduces ``hpc2n_preprocess(parse_swf(x))``
    row for row: ``sorted()`` is a stable identity on each already-sorted
    chunk, and every per-spec value depends only on its own row and jid.
    """
    if not window_s > 0.0:
        raise ValueError(f"window_s must be > 0, got {window_s}")
    buf: List[SwfJob] = []
    taken = 0           # rows accepted so far == jids already assigned
    lo = None           # first accepted submit time (window anchor)
    cur = None          # window index of the rows in buf
    last = -np.inf
    for row in iter_swf(text_or_path):
        if row.submit < last:
            raise ValueError(
                "swf log is not sorted by submit time (row jid "
                f"{row.jid}: submit {row.submit} after {last}); streaming "
                "ingest needs a sorted log — use the materialized "
                "'swf:<path>' workload kind instead")
        last = row.submit
        if lo is None:
            lo = row.submit
        k = int((row.submit - lo) // window_s)
        if buf and k != cur:
            yield hpc2n_preprocess(buf, start_jid=taken)
            taken += len(buf)
            buf = []
        cur = k
        buf.append(row)
        if n_jobs and taken + len(buf) >= n_jobs:
            break
    if buf:
        yield hpc2n_preprocess(buf, start_jid=taken)


def hpc2n_like_trace(
    n_jobs: int = 500,
    seed: int = 0,
    span_weeks: float = 1.0,
) -> List[JobSpec]:
    """Synthetic swf rows with HPC2N-like marginals, preprocessed per §5.3.1."""
    rng = np.random.default_rng(seed)
    node_kb = NODE_MEM_GB * 1024 * 1024
    rows: List[SwfJob] = []
    t = 0.0
    span = span_weeks * 7 * 86400.0
    mean_gap = span / max(1, n_jobs)
    for jid in range(n_jobs):
        t += float(rng.exponential(mean_gap))
        # sizes: mostly small, powers of two favoured, max 2*120 processors
        u = rng.random()
        if u < 0.35:
            procs = 1
        elif u < 0.85:
            procs = int(2 ** rng.integers(1, 6))      # 2..32
        else:
            procs = int(min(120, 2 ** rng.integers(5, 8)))
        # runtimes: log-uniform seconds..day, occasional multi-day
        lg = rng.uniform(np.log10(8.0), np.log10(86400.0))
        run = 10**lg * (10.0 if rng.random() < 0.02 else 1.0)
        # memory: >95% of jobs below 40% of node memory
        if rng.random() < 0.95:
            mem_frac = rng.uniform(0.01, 0.38)
        else:
            mem_frac = rng.uniform(0.4, 0.95)
        used_kb = mem_frac * node_kb
        rows.append(SwfJob(jid, t, run, procs, used_kb, 0.0))
    return hpc2n_preprocess(rows)
