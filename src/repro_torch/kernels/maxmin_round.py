"""One freeze round of the batched OPT=MIN water-filling, plain and CUDA.

Given per lane the frozen use ``f_use`` and unfrozen need ``u_need`` of
every node (the two matvecs of the round), the round:

1. computes node levels ``max(0, 1 - f_use) / u_need`` where
   ``u_need > 1e-12``;
2. scans the nodes in ascending order for the tolerance-updated running
   minimum (a node within 1e-15 of the current minimum joins the binding
   set, one more than 1e-15 below it restarts the set) — order-dependent,
   so it cannot be a parallel argmin;
3. caps the level at 1 when it is within 1e-12 of it (then every open
   column freezes), else freezes the open columns present on a binding
   node; a round that froze nothing freezes every open column;
4. writes the level into every open column of every live lane.

:func:`maxmin_round_plain` mirrors the JAX package's lockstep loop body
(``core/alloc_jax.py``, ``_build_maxmin``) op for op, with the scan as a
loop over nodes.  :func:`maxmin_round_cuda` launches the Hopper kernel of
``csrc/alloc.cu`` (one block per lane, the scan on one thread) that
replaces the vmapped scan and the masked freeze update; the two agree bit
for bit.
"""
from __future__ import annotations

from typing import Tuple

import torch

from . import cuda_lib

__all__ = ["maxmin_round_plain", "maxmin_round_cuda", "MAX_NODES"]

_EPS = 1e-12

#: the kernel keeps the binding node ids of a lane in 48 KB of shared memory
MAX_NODES = 12288


def maxmin_round_plain(
    f_use: torch.Tensor,
    u_need: torch.Tensor,
    present: torch.Tensor,
    frozen: torch.Tensor,
    y: torch.Tensor,
    live: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One freeze round in plain PyTorch.

    f_use, u_need: (B, N) float64; present: (B, N, W) bool; frozen: (B, W)
    bool; y: (B, W) float64; live: (B,) bool.  Returns the new ``(y,
    frozen)``; lanes with ``live`` False come back unchanged.
    """
    B, N = f_use.shape
    valid = u_need > _EPS
    levels = torch.maximum(torch.zeros_like(f_use), 1.0 - f_use) / torch.where(
        valid, u_need, torch.ones_like(u_need))
    best = torch.ones(B, dtype=f_use.dtype, device=f_use.device)
    binding = torch.zeros((B, N), dtype=torch.bool, device=f_use.device)
    arange_n = torch.arange(N, device=f_use.device)
    for n in range(N):
        lvl, v = levels[:, n], valid[:, n]
        lower = v & (lvl < best - 1e-15)
        tie = v & ~lower & ((lvl - best).abs() <= 1e-15)
        onehot = (arange_n == n)[None, :]
        binding = torch.where(
            lower[:, None], onehot,
            torch.where(tie[:, None], binding | onehot, binding))
        best = torch.where(lower, lvl, best)
    cap = best >= 1.0 - 1e-12
    best = torch.where(cap, torch.ones_like(best), best)
    on_binding = (present & binding[:, :, None]).any(dim=1)
    newly = torch.where(cap[:, None], ~frozen, on_binding & ~frozen)
    # a round that froze nothing freezes everything still open
    newly = torch.where(newly.any(dim=1, keepdim=True), newly, ~frozen)
    upd = live[:, None] & ~frozen
    y = torch.where(upd, best[:, None], y)
    frozen = frozen | (newly & live[:, None])
    return y, frozen


def _check(f_use, u_need, present, frozen, y, live) -> None:
    tensors = (f_use, u_need, present, frozen, y, live)
    dev = f_use.device
    if not all(t.is_cuda and t.device == dev for t in tensors):
        raise ValueError("maxmin_round_cuda needs all tensors on one CUDA "
                         "device")
    for t, dt in zip(tensors, (torch.float64, torch.float64, torch.bool,
                               torch.bool, torch.float64, torch.bool)):
        if t.dtype != dt:
            raise TypeError(f"maxmin_round_cuda: expected {dt}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError("maxmin_round_cuda takes contiguous tensors")
    if present.dim() != 3:
        raise ValueError(f"present must be (B, N, W), got {tuple(present.shape)}")
    B, N, W = present.shape
    for t, shape in ((f_use, (B, N)), (u_need, (B, N)), (frozen, (B, W)),
                     (y, (B, W)), (live, (B,))):
        if tuple(t.shape) != shape:
            raise ValueError(f"expected shape {shape}, got {tuple(t.shape)}")
    if N > MAX_NODES:
        raise ValueError(f"maxmin_round_cuda takes at most {MAX_NODES} "
                         f"nodes per lane, got {N}")
    if B >= 2**31 or W >= 2**31 or present.numel() >= 2**62:
        raise ValueError(f"shape {(B, N, W)} is too large")


def maxmin_round_cuda(
    f_use: torch.Tensor,
    u_need: torch.Tensor,
    present: torch.Tensor,
    frozen: torch.Tensor,
    y: torch.Tensor,
    live: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The CUDA kernel: same function as :func:`maxmin_round_plain`, bit for
    bit.  Launches on the current stream; raises on a refused launch."""
    _check(f_use, u_need, present, frozen, y, live)
    B, N, W = present.shape
    y_out = torch.empty((B, W), dtype=torch.float64, device=y.device)
    frozen_out = torch.empty((B, W), dtype=torch.bool, device=y.device)
    lib = cuda_lib.load_library("alloc")
    stream = torch.cuda.current_stream(y.device).cuda_stream
    rc = lib.repro_maxmin_round_f64(
        f_use.data_ptr(), u_need.data_ptr(), present.data_ptr(),
        frozen.data_ptr(), y.data_ptr(), live.data_ptr(), y_out.data_ptr(),
        frozen_out.data_ptr(), B, N, W, stream)
    if rc != 0:
        raise RuntimeError(f"maxmin_round kernel launch failed: CUDA error {rc}")
    return y_out, frozen_out
