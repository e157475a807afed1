"""repro_torch.workloads — the columnar Trace IR and the Lublin–Feitelson
workload generator behind declarative workload specs."""
