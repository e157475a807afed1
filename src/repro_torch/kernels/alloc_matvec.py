"""The water-filling matvec (§4.6, batched), plain and CUDA.

The batched allocation's primitive is a *sequential* masked matvec — for
every lane and node, accumulate ``weight[n, j] * x[j]`` over job columns
``j`` in strictly ascending order.  The order is the bit-identity contract:
the numpy kernel (``CSRIncidence.matvec``) accumulates left to right, so
any reformulation (pairwise sums, ``bmm``) rounds differently.  The
OPT=MIN solve runs it inside its own kernel (``kernels/maxmin_solve.py``);
as a launch of its own it computes the OPT=AVG floor Λ.

Both versions keep the contract:

* :func:`alloc_matvec_plain` materializes every product with one multiply,
  then runs an adds-only loop over columns (no fused multiply-add can form
  across two separate tensor ops);
* :func:`alloc_matvec_cuda` launches the Hopper kernel of
  ``csrc/alloc.cu`` (``__dmul_rn`` then ``__dadd_rn``, built with
  ``--fmad=false``).  It replaces the JAX package's Pallas kernel
  ``kernels/alloc_matvec.py`` (``alloc_matvec`` / ``_mv_kernel``).  It is
  bound by bytes and, at the main path's small shapes, by latency: a block
  takes one lane and 16 rows (so (16, 128, 32) fills the card with 128
  blocks), stages their contiguous run of weights into shared memory with
  coalesced 16-byte loads, all in flight together, and each row's chain
  then runs out of shared memory.

Padding columns contribute an exact ``+0.0``, which never changes a finite
partial sum.
"""
from __future__ import annotations

import torch

from . import cuda_lib

__all__ = ["alloc_matvec_plain", "alloc_matvec_cuda"]


def alloc_matvec_plain(weight: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Sequential masked matvec in plain PyTorch.

    weight: (B, N, W) float64; x: (B, W) float64.  Returns (B, N): per-lane
    per-node left-to-right accumulation of ``weight[b, n, j] * x[b, j]``.
    """
    B, N, W = weight.shape
    out = torch.zeros((B, N), dtype=weight.dtype, device=weight.device)
    if W == 0:
        return out
    prods = weight * x[:, None, :]          # one multiply, materialized
    for j in range(W):
        out = out + prods[:, :, j]          # adds only
    return out


def _check(weight: torch.Tensor, x: torch.Tensor) -> None:
    if not (weight.is_cuda and x.is_cuda and weight.device == x.device):
        raise ValueError("alloc_matvec_cuda needs both tensors on one CUDA "
                         "device")
    if weight.dtype != torch.float64 or x.dtype != torch.float64:
        raise TypeError("alloc_matvec_cuda takes float64 tensors, got "
                        f"{weight.dtype} and {x.dtype}")
    if weight.dim() != 3 or x.dim() != 2 or x.shape != (weight.shape[0],
                                                        weight.shape[2]):
        raise ValueError(f"shapes {tuple(weight.shape)} and {tuple(x.shape)} "
                         "are not (B, N, W) and (B, W)")
    if not (weight.is_contiguous() and x.is_contiguous()):
        raise ValueError("alloc_matvec_cuda takes contiguous tensors")
    if weight.numel() >= 2**62 or max(weight.shape) >= 2**31:
        raise ValueError(f"shape {tuple(weight.shape)} is too large")


def alloc_matvec_cuda(weight: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """The CUDA kernel: same function as :func:`alloc_matvec_plain`, bit
    for bit.  Launches on the current stream; raises on a refused launch."""
    _check(weight, x)
    B, N, W = weight.shape
    out = torch.empty((B, N), dtype=torch.float64, device=weight.device)
    lib = cuda_lib.load_library("alloc")
    stream = torch.cuda.current_stream(weight.device).cuda_stream
    rc = lib.repro_alloc_matvec_f64(weight.data_ptr(), x.data_ptr(),
                                    out.data_ptr(), B, N, W, stream)
    if rc != 0:
        raise RuntimeError(f"alloc_matvec kernel launch failed: CUDA error {rc}")
    return out
