"""The device an entry point runs on.

Every device entry point of the port takes ``device="cuda"`` unless the
caller passes ``device="cpu"``, where the kernels run as their plain
PyTorch versions.  With no CUDA device, ``"cuda"`` raises; nothing falls
back.
"""
from __future__ import annotations

import torch

__all__ = ["resolve_device"]


def resolve_device(device) -> torch.device:
    """``torch.device`` for an entry point's ``device`` argument; raises
    when CUDA is asked for and missing (no silent CPU fallback)."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available; pass device='cpu' to run the plain "
                "PyTorch versions of the kernels")
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}; use 'cuda' or 'cpu'")
    return dev
