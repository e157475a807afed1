"""Launchers of the port: the production mesh, sharding plans, the
roofline, the dry run (``python -m repro_torch.launch.dryrun``, not in
this facade, as in the reference) and ``python -m
repro_torch.launch.serve`` / ``train``.  None of them touches a device
when imported."""
from . import mesh, roofline, shardings  # noqa: F401
