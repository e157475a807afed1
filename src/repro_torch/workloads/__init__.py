"""repro_torch.workloads — the columnar Trace IR, the Lublin–Feitelson
workload generator, the HPC2N / swf preprocessing, the accelerator job
mix (``tpu``), and the open registry of workload kinds behind declarative
workload specs."""
from .jobgen import (DEFAULT_TPU_JOB_TYPES, HBM_BYTES, TpuJobType,
                     tpu_job_types, tpu_trace)

__all__ = ["TpuJobType", "tpu_job_types", "tpu_trace", "HBM_BYTES",
           "DEFAULT_TPU_JOB_TYPES"]
