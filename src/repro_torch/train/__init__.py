"""Serving substrate of the port: :mod:`repro_torch.train.serve`'s
continuous-batching ``BatchedServer``.  The training path comes with a
later slice (``ROADMAP.md``)."""
