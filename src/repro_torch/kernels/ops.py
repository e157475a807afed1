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
"""
from __future__ import annotations

from collections import Counter
from typing import Dict, Optional, Tuple

import torch

from .alloc_matvec import alloc_matvec_cuda, alloc_matvec_plain
from .flash_attention import (attention_instance, decode_instance,
                              flash_attention_cuda, flash_attention_plain,
                              flash_decode_cuda, flash_decode_plain)
from .maxmin_solve import maxmin_solve_cuda, maxmin_solve_plain, solve_route
from .node_usage import node_usage_cuda, node_usage_plain
from .rglru_scan import linear_recurrence_plain, rglru_route, rglru_scan_cuda
from .rwkv6_scan import wkv6_cuda, wkv6_plain, wkv6_route

__all__ = ["alloc_matvec", "maxmin_solve", "node_usage", "flash_attention",
           "flash_decode", "linear_recurrence", "wkv6", "launches", "routes",
           "reset_launches"]

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


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0,
                    q_offset: int = 0, scale: Optional[float] = None):
    """GQA attention of a prompt (see ``kernels/flash_attention.py``)."""
    if _on_cuda(q):
        out = flash_attention_cuda(q, k, v, causal=causal, window=window,
                                   q_offset=q_offset, scale=scale)
        launches["flash_attention"] += 1
        routes["flash_attention"][attention_instance(q, k, v)] += 1
        return out
    return flash_attention_plain(q, k, v, causal=causal, window=window,
                                 q_offset=q_offset, scale=scale)


def flash_decode(q, k_cache, v_cache, cur_len, *,
                 scale: Optional[float] = None):
    """One new token per request against a KV cache (see
    ``kernels/flash_attention.py``)."""
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
    (``rglru_route``) is chunked for a prefill, sequential otherwise."""
    if _on_cuda(a):
        out = rglru_scan_cuda(a, b, h0)
        launches["rglru_scan"] += 1
        routes["rglru_scan"][rglru_route(*a.shape)] += 1
        return out
    return linear_recurrence_plain(a, b, h0)


def wkv6(r, k, v, w, u, s0, *, state_out: Optional[torch.Tensor] = None
         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The RWKV6 WKV recurrence (see ``kernels/rwkv6_scan.py``); sT goes
    to ``state_out`` when given (it may be ``s0``).  Unlike the reference,
    which sends ``T == 1`` to its oracle, the card launches a kernel for
    every T, decode's single step included: the route (``wkv6_route``) is
    chunked for a prefill, sequential otherwise."""
    if _on_cuda(r):
        out = wkv6_cuda(r, k, v, w, u, s0, state_out=state_out)
        launches["wkv6"] += 1
        routes["wkv6"][wkv6_route(*r.shape, v.shape[-1])] += 1
        return out
    return wkv6_plain(r, k, v, w, u, s0, state_out=state_out)
