"""The kernels' oracles under the JAX package's names (its
``kernels/ref.py``), bound to the port's plain PyTorch versions.

They are what the CPU runs, what the kernels are held against on the card,
and what the training path differentiates: the backward of every kernel in
:mod:`repro_torch.kernels.ops` is autograd of the oracle.
"""
from __future__ import annotations

from .alloc_matvec import alloc_matvec_plain
from .flash_attention import flash_attention_plain, flash_decode_plain
from .rglru_scan import linear_recurrence_plain
from .rwkv6_scan import wkv6_plain

__all__ = [
    "flash_attention_ref", "flash_decode_ref", "wkv6_ref",
    "linear_recurrence_ref", "alloc_matvec_ref",
]

flash_attention_ref = flash_attention_plain
flash_decode_ref = flash_decode_plain
wkv6_ref = wkv6_plain
linear_recurrence_ref = linear_recurrence_plain
alloc_matvec_ref = alloc_matvec_plain
