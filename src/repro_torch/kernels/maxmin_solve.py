"""The batched OPT=MIN water-filling (§4.6), plain and CUDA.

Per lane, the solve runs freeze rounds until every column is frozen or
``n_active + 1`` rounds have run.  A round takes the two matvecs of the
lane (frozen use ``f_use``, unfrozen need ``u_need``), then:

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

:func:`maxmin_round_plain` is one such round over a batch, op for op the
body of the JAX package's lockstep loop (``core/alloc_jax.py``,
``_build_maxmin``), with the scan as a loop over nodes.
:func:`maxmin_solve_plain` is that lockstep loop: every lane steps while
any lane is live, with a host read of the done test each round.

:func:`maxmin_solve_cuda` launches the Hopper kernel of ``csrc/alloc.cu``
that replaces the whole ``while_loop`` of ``_build_maxmin``
(``alloc_jax.py:206-276``): one block runs one lane's rounds to the end,
so a dispatch is one launch and no host read.  The lane's weights stay in
shared memory across rounds where they fit (:func:`solve_route` says
``"shared"``), else they are read from global memory each round
(``"global"``).  Per lane the two agree bit for bit in the yields and in
the rounds run.
"""
from __future__ import annotations

from typing import Tuple

import torch

from . import cuda_lib
from .alloc_matvec import alloc_matvec_plain

__all__ = ["maxmin_round_plain", "maxmin_solve_plain", "maxmin_solve_cuda",
           "solve_route", "MAX_NODES"]

_EPS = 1e-12

#: the kernel keeps a level per node in shared memory
MAX_NODES = 8192
#: a solve block's dynamic shared memory: the tile route up to this, and
#: any route at most the card's 227 KB less the kernel's static bytes
TILE_SMEM_BYTES = 200 * 1024
SMEM_LIMIT_BYTES = 232448 - 1024


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


def maxmin_solve_plain(
    present: torch.Tensor,
    weight: torch.Tensor,
    active: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The lockstep water-filling in plain PyTorch.

    present: (B, N, W) bool; weight: (B, N, W) float64; active: (B, W)
    bool.  Returns ``(y, rounds)``: (B, W) float64 yields clipped to
    [0, 1], and (B,) int32, the rounds each lane was live.
    """
    B, N, W = weight.shape
    dev = weight.device
    n_active = active.sum(dim=1)
    y = torch.zeros((B, W), dtype=torch.float64, device=dev)
    rounds = torch.zeros(B, dtype=torch.int32, device=dev)
    frozen = ~active
    i = 0
    while True:
        # a lane stops on full freeze or after the n_active + 1 safety cap
        done = frozen.all(dim=1) | (n_active + 1 <= i)
        if bool(done.all()):
            break
        live = ~done
        f_use = alloc_matvec_plain(
            weight, torch.where(frozen, y, torch.zeros_like(y)))
        u_need = alloc_matvec_plain(weight, (~frozen).to(torch.float64))
        y, frozen = maxmin_round_plain(f_use, u_need, present, frozen, y,
                                       live)
        rounds += live.to(torch.int32)
        i += 1
    return torch.clip(y, 0.0, 1.0), rounds


def _solve_smem(N: int, W: int, tile: bool) -> int:
    """Dynamic shared-memory bytes of a solve block (``solve_smem`` of
    csrc/alloc.cu): x for both chains, a level a node, the presence bits
    and the binding mask, and the weight tile (odd row stride) when
    ``tile``."""
    words = -(-W // 32)
    doubles = 2 * W + N + (N * (W | 1) if tile else 0)
    return 8 * doubles + 4 * (N * words + words)


def solve_route(present: torch.Tensor, weight: torch.Tensor,
                active: torch.Tensor) -> str:
    """The solve instance a call takes, by shape alone: ``"shared"`` when
    the lane's weight tile and the rest fit in 200 KB of shared memory (128
    nodes: up to 128 columns), else ``"global"``."""
    _, N, W = weight.shape
    return "shared" if _solve_smem(N, W, True) <= TILE_SMEM_BYTES \
        else "global"


def _check(present, weight, active) -> None:
    tensors = (present, weight, active)
    for t, dt in zip(tensors, (torch.bool, torch.float64, torch.bool)):
        if t.dtype != dt:
            raise TypeError(f"maxmin_solve_cuda: expected {dt}, got {t.dtype}")
    if weight.dim() != 3:
        raise ValueError(f"weight must be (B, N, W), got {tuple(weight.shape)}")
    B, N, W = weight.shape
    if tuple(present.shape) != (B, N, W) or tuple(active.shape) != (B, W):
        raise ValueError(f"shapes {tuple(present.shape)}, "
                         f"{tuple(weight.shape)}, {tuple(active.shape)} are "
                         "not (B, N, W), (B, N, W) and (B, W)")
    if N > MAX_NODES:
        raise ValueError(f"maxmin_solve_cuda takes at most {MAX_NODES} "
                         f"nodes per lane, got {N}")
    if _solve_smem(N, W, False) > SMEM_LIMIT_BYTES:
        raise ValueError(f"a lane of {N} nodes x {W} columns does not fit "
                         f"in shared memory")
    if B >= 2**31 or weight.numel() >= 2**62:
        raise ValueError(f"shape {(B, N, W)} is too large")
    if not all(t.is_cuda and t.device == weight.device for t in tensors):
        raise ValueError("maxmin_solve_cuda needs all tensors on one CUDA "
                         "device")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("maxmin_solve_cuda takes contiguous tensors")


def maxmin_solve_cuda(
    present: torch.Tensor,
    weight: torch.Tensor,
    active: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The CUDA kernel: same function as :func:`maxmin_solve_plain`, bit
    for bit, in one launch of the instance :func:`solve_route` names, on
    the current stream; raises on a refused launch."""
    _check(present, weight, active)
    B, N, W = weight.shape
    y = torch.empty((B, W), dtype=torch.float64, device=weight.device)
    rounds = torch.empty(B, dtype=torch.int32, device=weight.device)
    lib = cuda_lib.load_library("alloc")
    stream = torch.cuda.current_stream(weight.device).cuda_stream
    rc = lib.repro_maxmin_solve_f64(
        present.data_ptr(), weight.data_ptr(), active.data_ptr(),
        y.data_ptr(), rounds.data_ptr(),
        int(solve_route(present, weight, active) == "shared"), B, N, W,
        stream)
    if rc != 0:
        raise RuntimeError(f"maxmin_solve kernel launch failed: CUDA error "
                           f"{rc}")
    return y, rounds
