"""repro_torch.workloads — the columnar Trace IR, the Lublin–Feitelson
workload generator, the HPC2N / swf preprocessing, and the open registry
of workload kinds behind declarative workload specs."""
