"""Kernel entry points of the allocation and serving paths, dispatched by
device.

A tensor on the CPU goes to the kernel's plain PyTorch version; a CUDA
tensor launches the Hopper kernel, or the call raises.  There is no
fallback between the two and no process-wide switch: the device of the
data decides.

``launches`` counts kernel launches per entry point (plain calls are not
counted), so a run can show that its main path went through the kernels,
and ``routes`` the launches of an entry point with more than one instance
by the instance taken (for attention, the kernel instance: ``"wgmma<2>"``,
``"mma<1>"``, ...); :func:`reset_launches` zeroes both.

Gradients.  ``flash_attention``, ``wkv6``, ``linear_recurrence`` and
``rglru_gated`` are differentiable, as the reference's ``custom_vjp``
wraps the first three (``src/repro/kernels/ops.py``): the forward is the
kernel, the backward is autograd of the oracle
(:mod:`repro_torch.kernels.ref`, or the gate chain's plain version)
recomputed from the saved inputs.  On a CUDA tensor with grad enabled the
call is a ``torch.autograd.Function`` whose forward launches the Hopper
kernel (counted as every launch) and whose backward differentiates the
plain version on the card; on the CPU autograd runs through the plain version
itself, as the reference's ``"ref"`` backend.  The JAX package has no
backward Pallas kernel, so none is owed here; hand-written backward
kernels are later performance work (``ROADMAP.md``).  ``flash_decode``
and the allocation kernels are forward-only, as in the reference.

On a ``meta`` tensor (the dry run: shapes, no data) a model kernel returns
empty outputs of its shapes and charges its own operations and bytes to
the active cost counter (:mod:`repro_torch.kernels.meta_cost`); its
backward is charged likewise.  No launch is counted.  The allocation
kernels refuse ``meta``.
"""
from __future__ import annotations

from collections import Counter
from typing import Callable, Dict, Optional, Tuple

import torch

from .alloc_matvec import alloc_matvec_cuda, alloc_matvec_plain
from .flash_attention import (attention_instance, decode_instance,
                              flash_attention_cuda, flash_attention_plain,
                              flash_decode_cuda, flash_decode_plain)
from . import meta_cost
from .maxmin_solve import maxmin_solve_cuda, maxmin_solve_plain, solve_route
from .node_usage import node_usage_cuda, node_usage_plain
from .rglru_scan import (CHUNKED_MIN_T, linear_recurrence_plain,
                         rglru_gated_cuda, rglru_gated_plain, rglru_gates,
                         rglru_route, rglru_scan_cuda)
from .rwkv6_scan import wkv6_cuda, wkv6_plain, wkv6_route

__all__ = ["alloc_matvec", "maxmin_solve", "node_usage", "flash_attention",
           "flash_decode", "linear_recurrence", "rglru_gated", "wkv6",
           "launches", "routes", "reset_launches"]

#: kernel launches per entry point since the last reset
launches: Dict[str, int] = {"alloc_matvec": 0, "maxmin_solve": 0,
                            "node_usage": 0, "flash_attention": 0, "flash_decode": 0,
                            "rglru_scan": 0, "wkv6": 0}
#: launches by the instance taken, since the last reset
routes: Dict[str, Counter] = {"maxmin_solve": Counter(),
                              "flash_attention": Counter(),
                              "flash_decode": Counter(),
                              "rglru_scan": Counter(), "wkv6": Counter()}


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0
    for c in routes.values():
        c.clear()


def _on_cuda(t: torch.Tensor) -> bool:
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"unsupported device {t.device}")


def _on_meta(t: torch.Tensor) -> bool:
    return t.device.type == "meta"


class _MetaKernel(torch.autograd.Function):
    """A model kernel on ``meta``: empty outputs of ``shapes`` (and
    ``dtypes``), its (flops, bytes) charged to the active counter, and
    twice that for the backward, whose gradients are empty too."""

    @staticmethod
    def forward(ctx, name, cost, shapes, dtypes, *inputs):
        ctx.name, ctx.cost = name, cost
        ctx.specs = [(t.shape, t.dtype) for t in inputs]
        meta_cost.charge(name, *cost)
        return tuple(torch.empty(s, dtype=d, device="meta")
                     for s, d in zip(shapes, dtypes))

    @staticmethod
    def backward(ctx, *grads):
        meta_cost.charge(ctx.name + " backward", 2 * ctx.cost[0],
                         2 * ctx.cost[1])
        return (None, None, None, None) + tuple(
            torch.empty(s, dtype=d, device="meta") if n else None
            for (s, d), n in zip(ctx.specs, ctx.needs_input_grad[4:]))


def _meta_call(name, cost, outputs, *inputs):
    shapes = [tuple(s) for s, _ in outputs]
    dtypes = [d for _, d in outputs]
    return _MetaKernel.apply(name, cost, shapes, dtypes, *inputs)


def alloc_matvec(weight: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Sequential masked matvec over job columns — bit-exact against the
    numpy CSR accumulation (see ``kernels/alloc_matvec.py``)."""
    if _on_cuda(weight):
        out = alloc_matvec_cuda(weight, x)
        launches["alloc_matvec"] += 1
        return out
    return alloc_matvec_plain(weight, x)


def maxmin_solve(present: torch.Tensor, weight: torch.Tensor,
                 active: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The OPT=MIN water-filling of every lane, ``(y, rounds)`` (see
    ``kernels/maxmin_solve.py``): on the card one launch and no host
    read."""
    if _on_cuda(weight):
        out = maxmin_solve_cuda(present, weight, active)
        launches["maxmin_solve"] += 1
        routes["maxmin_solve"][solve_route(present, weight, active)] += 1
        return out
    return maxmin_solve_plain(present, weight, active)


def node_usage(nodes: torch.Tensor, vals: torch.Tensor,
               n_nodes: int) -> torch.Tensor:
    """Per-node sums of every lane's ``(node, value)`` list in list order,
    bit-equal to an in-order ``np.add.at`` (see
    ``kernels/node_usage.py``)."""
    if _on_cuda(vals):
        out = node_usage_cuda(nodes, vals, n_nodes)
        launches["node_usage"] += 1
        return out
    return node_usage_plain(nodes, vals, n_nodes)


def _differentiable(*tensors) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


class _KernelOracle(torch.autograd.Function):
    """Forward: ``kernel`` on contiguous inputs.  Backward: autograd of
    ``oracle`` (the plain version) recomputed from the saved inputs."""

    @staticmethod
    def forward(ctx, kernel: Callable, oracle: Callable, *inputs):
        ctx.oracle = oracle
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(*inputs)
        return kernel(*(t.contiguous() for t in inputs))

    @staticmethod
    def backward(ctx, *grads):
        inputs = ctx.saved_tensors
        needs = ctx.needs_input_grad[2:]
        with torch.enable_grad():
            xs = [t.detach().requires_grad_(n) for t, n in zip(inputs, needs)]
            out = ctx.oracle(*xs)
        outs = out if isinstance(out, tuple) else (out,)
        pairs = [(o, g) for o, g in zip(outs, grads) if g is not None]
        wanted = [x for x, n in zip(xs, needs) if n]
        got = iter(torch.autograd.grad([o for o, _ in pairs], wanted,
                                       [g for _, g in pairs],
                                       allow_unused=True))
        return (None, None) + tuple(next(got) if n else None for n in needs)


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0,
                    q_offset: int = 0, scale: Optional[float] = None):
    """GQA attention of a prompt (see ``kernels/flash_attention.py``);
    differentiable, its backward that of the plain version."""
    kw = dict(causal=causal, window=window, q_offset=q_offset, scale=scale)
    if _on_meta(q):
        out_shape = q.shape[:-1] + v.shape[-1:]
        return _meta_call("flash_attention", meta_cost.attention_cost(
            q, k, v, causal, window, q_offset), [(out_shape, q.dtype)],
            q, k, v)[0]
    if _on_cuda(q):
        def kernel(q_, k_, v_):
            out = flash_attention_cuda(q_, k_, v_, **kw)
            launches["flash_attention"] += 1
            routes["flash_attention"][attention_instance(q_, k_, v_)] += 1
            return out
        if _differentiable(q, k, v):
            return _KernelOracle.apply(
                kernel, lambda *a: flash_attention_plain(*a, **kw), q, k, v)
        return kernel(q, k, v)
    return flash_attention_plain(q, k, v, **kw)


def flash_decode(q, k_cache, v_cache, cur_len, *,
                 scale: Optional[float] = None):
    """One new token per request against a KV cache (see
    ``kernels/flash_attention.py``)."""
    if _on_meta(q):
        out_shape = q.shape[:-1] + v_cache.shape[-1:]
        return _meta_call("flash_decode", meta_cost.decode_cost(
            q, k_cache, v_cache, cur_len), [(out_shape, q.dtype)],
            q, k_cache, v_cache)[0]
    if _on_cuda(q):
        out = flash_decode_cuda(q, k_cache, v_cache, cur_len, scale=scale)
        launches["flash_decode"] += 1
        routes["flash_decode"][decode_instance(q, k_cache, v_cache)] += 1
        return out
    return flash_decode_plain(q, k_cache, v_cache, cur_len, scale=scale)


def linear_recurrence(a, b, h0) -> Tuple[torch.Tensor, torch.Tensor]:
    """The RG-LRU recurrence (see ``kernels/rglru_scan.py``).  Unlike the
    reference, which sends ``T == 1`` to its oracle, the card launches a
    kernel for every T, decode's single step included: the route
    (``rglru_route``) is chunked for a prefill, sequential otherwise.
    Differentiable, its backward that of the plain version."""
    if _on_meta(a):
        B, T, W = a.shape
        return _meta_call("rglru_scan", meta_cost.rglru_cost(a, b, h0),
                          [((B, T, W), torch.float32),
                           ((B, W), torch.float32)], a, b, h0)
    if _on_cuda(a):
        def kernel(a_, b_, h0_):
            out = rglru_scan_cuda(a_, b_, h0_)
            launches["rglru_scan"] += 1
            routes["rglru_scan"][rglru_route(*a_.shape)] += 1
            return out
        if _differentiable(a, b, h0):
            return _KernelOracle.apply(kernel, linear_recurrence_plain,
                                       a, b, h0)
        return kernel(a, b, h0)
    return linear_recurrence_plain(a, b, h0)


def rglru_gated(xc, rg_pre, ig_pre, rg_b, ig_b, lam, h0, *,
                state_out: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The RG-LRU layer's gates and recurrence, ``(h, hT)`` (see
    ``kernels/rglru_scan.py``); hT goes to ``state_out`` when given (it may
    be ``h0``).  On the card a call of fewer than ``CHUNKED_MIN_T`` steps
    (a decode step) is one launch of the ``"gated"`` route, counted under
    ``rglru_scan``.  Elsewhere — a prefill on the card, the CPU, ``meta``
    — the gate chain runs as PyTorch operators and then
    :func:`linear_recurrence` (the chunked route on the card, the plain
    loop on the CPU, its cost on ``meta``).  Differentiable (with
    ``state_out`` None), its backward that of the plain version."""
    args = (xc, rg_pre, ig_pre, rg_b, ig_b, lam, h0)
    if (not _on_meta(xc) and _on_cuda(xc)
            and xc.shape[1] < CHUNKED_MIN_T):
        def kernel(*a):
            out = rglru_gated_cuda(*a, state_out=state_out)
            launches["rglru_scan"] += 1
            routes["rglru_scan"]["gated"] += 1
            return out
        if _differentiable(*args):
            if state_out is not None:
                raise ValueError("a differentiable rglru_gated call takes "
                                 "no state_out")
            return _KernelOracle.apply(kernel, rglru_gated_plain, *args)
        return kernel(*(t.contiguous() for t in args))
    a, bt = rglru_gates(xc, rg_pre, ig_pre, rg_b, ig_b, lam)
    h, hT = linear_recurrence(a, bt, h0)
    if state_out is None:
        return h, hT
    state_out.copy_(hT)
    return h, state_out


def wkv6(r, k, v, w, u, s0, *, state_out: Optional[torch.Tensor] = None
         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The RWKV6 WKV recurrence (see ``kernels/rwkv6_scan.py``); sT goes
    to ``state_out`` when given (it may be ``s0``).  Unlike the reference,
    which sends ``T == 1`` to its oracle, the card launches a kernel for
    every T, decode's single step included: the route (``wkv6_route``) is
    chunked for a prefill, sequential otherwise.  Differentiable (with
    ``state_out`` None), its backward that of the plain version."""
    if _on_meta(r):
        B, T, H, _ = r.shape
        y, sT = _meta_call("wkv6", meta_cost.wkv6_cost(r, k, v, w, u, s0),
                           [((B, T, H, v.shape[-1]), torch.float32),
                            (s0.shape, torch.float32)], r, k, v, w, u, s0)
        return y, (sT if state_out is None else state_out)
    if _on_cuda(r):
        def kernel(r_, k_, v_, w_, u_, s0_):
            out = wkv6_cuda(r_, k_, v_, w_, u_, s0_, state_out=state_out)
            launches["wkv6"] += 1
            routes["wkv6"][wkv6_route(*r_.shape, v_.shape[-1])] += 1
            return out
        if _differentiable(r, k, v, w, u, s0):
            if state_out is not None:
                raise ValueError("a differentiable wkv6 call takes no "
                                 "state_out")
            return _KernelOracle.apply(kernel, wkv6_plain, r, k, v, w, u, s0)
        return kernel(r, k, v, w, u, s0)
    return wkv6_plain(r, k, v, w, u, s0, state_out=state_out)
