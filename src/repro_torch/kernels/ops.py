"""Kernel entry points of the allocation path, dispatched by device.

A tensor on the CPU goes to the kernel's plain PyTorch version; a CUDA
tensor launches the Hopper kernel, or the call raises.  There is no
fallback between the two and no process-wide switch: the device of the
data decides.

``launches`` counts kernel launches per entry point (plain calls are not
counted), so a run can show that its main path went through the kernels;
:func:`reset_launches` zeroes the counts.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from .alloc_matvec import alloc_matvec_cuda, alloc_matvec_plain
from .maxmin_round import maxmin_round_cuda, maxmin_round_plain

__all__ = ["alloc_matvec", "maxmin_round", "launches", "reset_launches"]

#: kernel launches per entry point since the last reset
launches: Dict[str, int] = {"alloc_matvec": 0, "maxmin_round": 0}


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


def _on_cuda(t: torch.Tensor) -> bool:
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"unsupported device {t.device}")


def alloc_matvec(weight: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Sequential masked matvec over job columns — bit-exact against the
    numpy CSR accumulation (see ``kernels/alloc_matvec.py``)."""
    if _on_cuda(weight):
        out = alloc_matvec_cuda(weight, x)
        launches["alloc_matvec"] += 1
        return out
    return alloc_matvec_plain(weight, x)


def maxmin_round(
    f_use: torch.Tensor,
    u_need: torch.Tensor,
    present: torch.Tensor,
    frozen: torch.Tensor,
    y: torch.Tensor,
    live: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One freeze round of the lockstep water-filling (see
    ``kernels/maxmin_round.py``)."""
    if _on_cuda(f_use):
        out = maxmin_round_cuda(f_use, u_need, present, frozen, y, live)
        launches["maxmin_round"] += 1
        return out
    return maxmin_round_plain(f_use, u_need, present, frozen, y, live)
