"""repro_torch — the PyTorch/CUDA port of the DFRS scheduling reproduction.

It runs the paper's scheduling path (a Lublin trace through the event-loop
engine, with the §4.6 OPT=MIN / OPT=AVG reallocations batched onto one
device) with hand-written Hopper kernels for the water-filling.  The public
surface is :mod:`repro_torch.api`.  The package imports ``torch``, numpy
and scipy only.
"""
from __future__ import annotations

__all__ = ["api"]


def __getattr__(name):
    # lazy: `import repro_torch` stays cheap; `repro_torch.api` loads on
    # first touch
    if name == "api":
        import importlib
        return importlib.import_module(".api", __name__)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
