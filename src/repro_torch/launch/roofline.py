"""Roofline terms of a dry-run record (a port of the JAX package's
``launch/roofline.py``), and the adapter from dry-run records to the
flat records the ``tpu`` workload kind reads.

Hardware model: one NVIDIA H100 SXM a device (:class:`HW`'s defaults, each
from the data sheet named beside it).

Terms (seconds, lower bound per step):
    compute    = FLOPs / (chips * peak FLOP/s)
    memory     = bytes accessed / (chips * HBM bytes/s)
    collective = per-device collective payload / link bytes/s

The dry run (``launch.dryrun``) gives FLOPs and bytes from a trace of the
step on ``meta`` tensors (``launch.cost``) and the collective payload from
its sharding plan.  :func:`parse_collectives` models the payload of the
collectives in an XLA HLO text, the reference's way: it is kept so that
HLO and records from the JAX package can be read here; the port's own
dry run has no HLO.

The adapter (:func:`load_records`, :func:`bytes_per_chip`,
:func:`jobgen_records`) lives here because the port has no benchmark
folder: it is the JAX package's ``benchmarks/roofline.py`` adapter, over
``experiments/dryrun_torch``.
"""
from __future__ import annotations

import glob
import json
import os
import re
from dataclasses import dataclass, field
from typing import Dict, List

__all__ = ["HW", "CollectiveStats", "parse_collectives", "roofline_terms",
           "load_records", "bytes_per_chip", "jobgen_records",
           "DRYRUN_DIR"]

# NVIDIA H100 SXM5 data sheet: dense (no sparsity) bf16 tensor-core peak
PEAK_FLOPS = 989e12
# NVIDIA H100 SXM5 data sheet: HBM3 bandwidth
HBM_BW = 3.35e12
# the slowest hop of a 16-wide ring: one 400 Gb/s NDR InfiniBand port a GPU
# (ConnectX-7, as a DGX H100 has; a 16-wide axis spans two 8-GPU NVLink
# nodes).  Inside a node NVLink 4 gives 450e9 bytes/s a direction.
LINK_BW = 50e9

#: where ``python -m repro_torch.launch.dryrun`` writes by default
DRYRUN_DIR = "experiments/dryrun_torch"


@dataclass
class HW:
    chips: int
    peak_flops: float = PEAK_FLOPS
    hbm_bw: float = HBM_BW
    ici_bw: float = LINK_BW       # the reference's name: the collective link


_DTYPE_BYTES = {
    "pred": 1, "s8": 1, "u8": 1, "s16": 2, "u16": 2, "bf16": 2, "f16": 2,
    "s32": 4, "u32": 4, "f32": 4, "s64": 8, "u64": 8, "f64": 8, "c64": 8,
    "c128": 16,
}

# "bf16[2,16,128]{2,1,0} all-gather(" etc.  Result type precedes the op name.
_COLL_RE = re.compile(
    r"=\s*(?:\(([^)]*)\)|(\w+)\[([\d,]*)\][^ ]*)\s+"
    r"(all-gather|all-reduce|reduce-scatter|all-to-all|collective-permute)"
    r"(?:-start)?\(")
_SHAPE_RE = re.compile(r"(\w+)\[([\d,]*)\]")
_GROUPS_RE = re.compile(r"replica_groups=\{(\{[^}]*\})")
_GROUPS_IOTA_RE = re.compile(r"replica_groups=\[(\d+),(\d+)\]")


def _shape_bytes(dtype: str, dims: str) -> int:
    n = 1
    for d in dims.split(","):
        if d.strip():
            n *= int(d)
    return n * _DTYPE_BYTES.get(dtype, 4)


def _group_size(line: str, total: int) -> int:
    m = _GROUPS_IOTA_RE.search(line)
    if m:
        return int(m.group(2))                   # [n_groups, group_size]
    m = _GROUPS_RE.search(line)
    if m:
        first = m.group(1).strip("{}")
        return len([x for x in first.split(",") if x.strip()]) or total
    return total


@dataclass
class CollectiveStats:
    """Byte accounting for one step (per device)."""

    op_bytes: Dict[str, float] = field(default_factory=dict)  # result bytes
    op_counts: Dict[str, int] = field(default_factory=dict)
    payload_bytes: float = 0.0      # ring-modeled per-device traffic
    raw_bytes: float = 0.0          # plain sum of result-shape bytes

    def add(self, kind: str, nbytes: float, group: int) -> None:
        """One collective of ``kind`` whose result is ``nbytes`` on each
        device, over a group of ``group`` devices (ring factors)."""
        self.op_bytes[kind] = self.op_bytes.get(kind, 0.0) + nbytes
        self.op_counts[kind] = self.op_counts.get(kind, 0) + 1
        self.raw_bytes += nbytes
        g = max(group, 1)
        ring = (g - 1) / g
        if kind == "all-reduce":
            self.payload_bytes += 2.0 * ring * nbytes
        elif kind == "all-gather":
            self.payload_bytes += ring * nbytes            # result = gathered
        elif kind == "reduce-scatter":
            self.payload_bytes += ring * nbytes * g        # result = scattered
        elif kind == "all-to-all":
            self.payload_bytes += ring * nbytes
        else:                                               # collective-permute
            self.payload_bytes += nbytes


def parse_collectives(hlo_text: str, total_devices: int) -> CollectiveStats:
    stats = CollectiveStats()
    for line in hlo_text.splitlines():
        m = _COLL_RE.search(line)
        if not m:
            continue
        tuple_body, dtype, dims, kind = m.groups()
        if tuple_body is not None:
            nbytes = sum(_shape_bytes(dt, dd)
                         for dt, dd in _SHAPE_RE.findall(tuple_body))
        else:
            nbytes = _shape_bytes(dtype, dims)
        stats.add(kind, float(nbytes), _group_size(line, total_devices))
    return stats


def roofline_terms(flops: float, bytes_accessed: float,
                   coll: CollectiveStats, hw: HW) -> Dict[str, float]:
    """All three terms in seconds + bottleneck id.

    ``flops``/``bytes_accessed`` are whole-program totals (every device);
    the collective payload is already per device."""
    compute = flops / (hw.chips * hw.peak_flops)
    memory = bytes_accessed / (hw.chips * hw.hbm_bw)
    collective = coll.payload_bytes / hw.ici_bw
    terms = {"compute_s": compute, "memory_s": memory,
             "collective_s": collective}
    terms["bottleneck"] = max(terms, key=lambda k: terms[k]).replace("_s", "")
    terms["step_s"] = max(compute, memory, collective)
    return terms


# --------------------------------------------------------------------------- #
# dry-run records -> the ``tpu`` kind's records                                #
# --------------------------------------------------------------------------- #
def load_records(mesh: str = "single", out_dir: str = DRYRUN_DIR
                 ) -> List[dict]:
    """Every ``<arch>__<shape>__<mesh>.json`` record of a dry run, in file
    name order."""
    recs = []
    for path in sorted(glob.glob(os.path.join(out_dir, f"*__{mesh}.json"))):
        with open(path) as f:
            recs.append(json.load(f))
    return recs


def bytes_per_chip(rec: dict) -> float:
    """Arguments + temporaries + outputs - aliased (donated) bytes: what a
    device holds at the step's peak."""
    m = rec.get("memory_analysis", {})
    return (m.get("argument_size_in_bytes", 0.0)
            + m.get("temp_size_in_bytes", 0.0)
            + m.get("output_size_in_bytes", 0.0)
            - m.get("alias_size_in_bytes", 0.0))


def jobgen_records(mesh: str = "single", out_dir: str = DRYRUN_DIR
                   ) -> List[dict]:
    """The flat records ``workloads.jobgen.tpu_job_types`` (and so the
    ``tpu`` kind's ``records=`` file) reads, one an ``ok`` cell."""
    out = []
    for rec in load_records(mesh, out_dir):
        if rec.get("status") != "ok":
            continue
        r = rec["roofline"]
        out.append({
            "arch": rec["arch"], "shape": rec["shape"],
            "compute_s": r["compute_s"], "memory_s": r["memory_s"],
            "collective_s": r["collective_s"],
            "bytes_per_device": bytes_per_chip(rec),
            "n_chips": rec["chips"],
        })
    return out
