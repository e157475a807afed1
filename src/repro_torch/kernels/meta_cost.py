"""What a kernel costs, counted on ``meta`` tensors (the dry run).

On a ``meta`` tensor a model kernel (``ops.flash_attention``,
``flash_decode``, ``wkv6``, ``linear_recurrence``) runs nothing: it
returns empty outputs of the kernel's shapes and charges the kernel's own
operations and bytes to the innermost active counter (``launch.cost``'s
``CostTrace`` pushes itself here).  The formulas are those of the bound on
``chip_smoke.py``'s kernels line: the work these inputs need (the pairs a
causal or windowed mask keeps; a decode over every slot of its cache, as
an abstract position gives), each input read once and each output written
once.  A kernel's backward (autograd of the plain version on the card, as
the reference's ``custom_vjp``) is charged twice its forward.
"""
from __future__ import annotations

from contextlib import contextmanager
from typing import List, Tuple

import numpy as np

__all__ = ["charge", "region", "attention_pairs", "attention_cost", "decode_cost",
           "wkv6_cost", "rglru_cost"]

#: the active counters, innermost last (``launch.cost.CostTrace``)
_COUNTERS: List = []


def charge(kernel: str, flops: float, nbytes: float) -> None:
    """Adds one kernel call's work to the innermost active counter."""
    if _COUNTERS:
        _COUNTERS[-1].charge_kernel(kernel, flops, nbytes)


@contextmanager
def region(name: str):
    """Tags what the active counter sees allocated inside as ``name`` (the
    dry run lays some regions out differently on a mesh); nothing without
    a counter."""
    if not _COUNTERS:
        yield
        return
    counter = _COUNTERS[-1]
    outer, counter.region = counter.region, name
    try:
        yield
    finally:
        counter.region = outer


def attention_pairs(Tq: int, Tk: int, causal: bool, window: int,
                    q_offset: int = 0) -> int:
    """(row, key) pairs the masks keep: the work attention must do."""
    pos = q_offset + np.arange(Tq, dtype=np.int64)
    lo = np.maximum(0, pos - window + 1) if window > 0 else np.zeros_like(pos)
    hi = np.minimum(Tk, pos + 1) if causal else np.full_like(pos, Tk)
    return int(np.maximum(0, hi - lo).sum())


def attention_cost(q, k, v, causal: bool, window: int, q_offset: int
                   ) -> Tuple[float, float]:
    """(operations, bytes) of a prompt's attention: 2 (hd + hdv) per kept
    (row, key) pair and head; q read and o written, k and v read."""
    B, Tq, H, hd = q.shape
    Tk, Hkv, hdv = k.shape[1], k.shape[2], v.shape[-1]
    ops = 2 * (hd + hdv) * H * B * attention_pairs(Tq, Tk, causal, window,
                                                   q_offset)
    nbytes = (B * Tq * H * (hd + hdv) * q.element_size()
              + B * Tk * Hkv * (hd * k.element_size()
                                + hdv * v.element_size()))
    return float(ops), float(nbytes)


def decode_cost(q, k_cache, v_cache, cur_len) -> Tuple[float, float]:
    """(operations, bytes) of one token a request against its cache: the
    valid slots, every slot unless ``cur_len`` is a Python int."""
    B, H, hd = q.shape
    S, Hkv, hdv = k_cache.shape[1], k_cache.shape[2], v_cache.shape[-1]
    valid = min(cur_len + 1, S) if isinstance(cur_len, int) else S
    ops = 2 * (hd + hdv) * H * B * valid
    nbytes = (B * H * (hd + hdv) * q.element_size()
              + B * valid * Hkv * (hd * k_cache.element_size()
                                   + hdv * v_cache.element_size()))
    return float(ops), float(nbytes)


def wkv6_cost(r, k, v, w, u, s0) -> Tuple[float, float]:
    """(operations, bytes) of the WKV recurrence: 5 flops a (row, column)
    pair of each head's state a step, 3 a row, 2 a column; r, k, v read in
    their type, w, u, s0 in fp32, y and sT written in fp32."""
    B, T, H, dk = r.shape
    dv = v.shape[-1]
    ops = B * T * H * (5 * dk * dv + 3 * dk + 2 * dv)
    nbytes = (r.numel() * r.element_size() + k.numel() * k.element_size()
              + v.numel() * v.element_size()
              + 4 * (w.numel() + H * dk + 2 * B * H * dk * dv
                     + B * T * H * dv))
    return float(ops), float(nbytes)


def rglru_cost(a, b, h0) -> Tuple[float, float]:
    """(operations, bytes) of h_t = a_t h_{t-1} + b_t: 2 flops an element;
    a and b read, h written (fp32), h0 read and hT written."""
    B, T, W = a.shape
    return float(2 * B * T * W), float(4 * (3 * B * T * W + 2 * B * W))
