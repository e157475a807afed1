"""repro_torch.core — job model, incidence kernels, greedy placement, policy
grammar, engine state, and the batched torch allocation backend."""
