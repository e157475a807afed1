"""repro_torch.sched — the scheduling engine, its policy components,
metrics, cluster events, the session event loop and batched sweeps."""
