"""Top-level ATen operators one training step dispatches from the host
(traced after the window: a count that repeats exactly)."""


def read(rec):
    return rec.get("host_ops_per_step")
