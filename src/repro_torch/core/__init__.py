"""repro_torch.core — job model, incidence kernels, greedy placement, MCB8
packing and MCB8-stretch, policy grammar, engine state, the batched
torch allocation backend, the pure-Python allocation oracle
(``alloc_reference``), and EQUIPARTITION on one unit resource (the
Theorem-2/3/4 analysis)."""
from .equipartition import equipartition_schedule, max_stretch, thm4_instance
from .mcb8 import MCB8Result, mcb8, mcb8_pack
from .stretch_opt import (StretchResult, improve_avg_stretch,
                          improve_max_stretch, mcb8_stretch)

__all__ = [
    "mcb8", "mcb8_pack", "MCB8Result",
    "mcb8_stretch", "improve_max_stretch", "improve_avg_stretch",
    "StretchResult",
    "equipartition_schedule", "max_stretch", "thm4_instance",
]
