"""The FLOP and byte arithmetic of the configurations, one module a kind
of model, frozen with the benchmark: counted from shapes, never from the
program."""
