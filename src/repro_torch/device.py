"""The device an entry point runs on.

Every device entry point of the port takes ``device="cuda"`` unless the
caller passes ``device="cpu"``, where the kernels run as their plain
PyTorch versions.  With no CUDA device, ``"cuda"`` raises; nothing falls
back.

A failure of the allocation backend's device side — no CUDA device where
one was asked for, a kernel that fails to build or launch, a CUDA error
in its copies or launches — is a :class:`BackendFault`
(``resolve_device``, ``TorchBatchedAllocator`` on the card, the
node-usage kernel).  It says nothing about the simulation's inputs and
need not recur on a replay, so callers that treat an op's failure as
deterministic (the session server's journal) tell it apart by its type.
"""
from __future__ import annotations

__all__ = ["BackendFault", "resolve_device"]


class BackendFault(RuntimeError):
    """The allocation backend failed (not the simulation it serves)."""


def resolve_device(device) -> torch.device:
    """``torch.device`` for an entry point's ``device`` argument; raises
    when CUDA is asked for and missing (no silent CPU fallback).
    ``"meta"`` (shapes and dtypes, no data: the dry run's tensors) is
    accepted too."""
    import torch

    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise BackendFault(
                "CUDA is not available; pass device='cpu' to run the plain "
                "PyTorch versions of the kernels")
    elif dev.type not in ("cpu", "meta"):
        raise ValueError(f"unsupported device {dev}; use 'cuda' or 'cpu'")
    return dev
