"""repro_torch.workloads — HPC workload generation and trace handling
(paper §5.3): the columnar Trace IR, the open registry of declarative
seeded generators used by sweep cells, and the generator modules
(Lublin–Feitelson, the HPC2N / swf preprocessing, the accelerator job
mix ``tpu``)."""
from .trace import Trace, as_trace
from .lublin import lublin_trace, scale_to_load, offered_load
from .hpc2n import (parse_swf, iter_swf, iter_swf_windows, hpc2n_preprocess,
                    hpc2n_like_trace)
from .jobgen import (tpu_job_types, tpu_trace, DEFAULT_TPU_JOB_TYPES,
                     HBM_BYTES, TpuJobType)
from .registry import (WorkloadSpec, WorkloadKind, make_trace, make_trace_ir,
                       parse_workload, register_workload, list_workloads,
                       stream_trace, trace_cache_clear, trace_cache_info,
                       workload_kind)

__all__ = [
    "Trace", "as_trace",
    "lublin_trace", "scale_to_load", "offered_load",
    "parse_swf", "iter_swf", "iter_swf_windows", "hpc2n_preprocess",
    "hpc2n_like_trace",
    "tpu_job_types", "tpu_trace", "DEFAULT_TPU_JOB_TYPES",
    "WorkloadSpec", "WorkloadKind", "make_trace", "make_trace_ir",
    "parse_workload", "register_workload", "list_workloads", "workload_kind",
    "stream_trace",
    # beyond the reference's list: the port's own surface
    "TpuJobType", "HBM_BYTES", "trace_cache_info", "trace_cache_clear",
]
