"""The RG-LRU linear recurrence ``h_t = a_t * h_{t-1} + b_t``, plain and
CUDA.

Elementwise over the LRU width, from a carry ``h0``: a, b (B, T, W), h0
(B, W); both versions return ``(h (B, T, W), hT (B, W))`` in fp32.

* :func:`linear_recurrence_plain` — a sequential loop over T, one multiply
  then one add per step (the plain version of the reference's
  ``kernels/ref.py`` ``linear_recurrence_ref``, which is an associative
  scan: the two round differently, within the reference's kernel
  tolerance atol 1e-5, rtol 1e-4);
* :func:`rglru_scan_cuda` — the Hopper kernel of ``csrc/rglru.cu``, one
  thread per channel with the same sequential order and separately rounded
  operations, so it equals the plain version bit for bit.  It replaces the
  JAX package's Pallas kernel ``kernels/rglru_scan.py`` (``rglru_scan`` /
  ``_rglru_kernel``).
"""
from __future__ import annotations

from typing import Tuple

import torch

from . import cuda_lib

__all__ = ["linear_recurrence_plain", "rglru_scan_cuda"]


def linear_recurrence_plain(a, b, h0) -> Tuple[torch.Tensor, torch.Tensor]:
    af, bf = a.float(), b.float()
    h = h0.float()
    out = torch.empty(af.shape, dtype=torch.float32, device=af.device)
    for t in range(af.shape[1]):
        h = torch.add(torch.mul(af[:, t], h), bf[:, t])   # two roundings
        out[:, t] = h
    return out, h


def rglru_scan_cuda(a, b, h0) -> Tuple[torch.Tensor, torch.Tensor]:
    """The CUDA kernel: same function as :func:`linear_recurrence_plain`,
    bit for bit.  Takes fp32 contiguous tensors; launches on the current
    stream; raises on a refused launch."""
    if not (a.is_cuda and b.device == a.device and h0.device == a.device):
        raise ValueError("rglru_scan_cuda needs a, b and h0 on one CUDA "
                         "device")
    if any(t.dtype != torch.float32 for t in (a, b, h0)):
        raise TypeError(f"rglru_scan_cuda takes fp32 tensors, got {a.dtype}, "
                        f"{b.dtype}, {h0.dtype}")
    if a.dim() != 3 or b.shape != a.shape or h0.shape != (a.shape[0],
                                                          a.shape[2]):
        raise ValueError(f"shapes {tuple(a.shape)}, {tuple(b.shape)}, "
                         f"{tuple(h0.shape)} are not (B, T, W) x2 and (B, W)")
    if not all(t.is_contiguous() for t in (a, b, h0)):
        raise ValueError("rglru_scan_cuda takes contiguous tensors")
    if a.numel() >= 2**62 or max(a.shape) >= 2**31:
        raise ValueError(f"shape {tuple(a.shape)} is too large")
    B, T, W = a.shape
    h = torch.empty((B, T, W), dtype=torch.float32, device=a.device)
    hT = torch.empty((B, W), dtype=torch.float32, device=a.device)
    lib = cuda_lib.load_library("rglru")
    stream = torch.cuda.current_stream(a.device).cuda_stream
    rc = lib.repro_rglru_scan_f32(a.data_ptr(), b.data_ptr(), h0.data_ptr(),
                                  h.data_ptr(), hT.data_ptr(), B, T, W, stream)
    if rc != 0:
        raise RuntimeError(f"rglru_scan kernel launch failed: CUDA error {rc}")
    return h, hT
