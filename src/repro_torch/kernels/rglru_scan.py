"""The RG-LRU linear recurrence ``h_t = a_t * h_{t-1} + b_t``, plain and
CUDA.

Elementwise over the LRU width, from a carry ``h0``: a, b (B, T, W), h0
(B, W); every version returns ``(h (B, T, W), hT (B, W))`` in fp32.

* :func:`linear_recurrence_plain` — a sequential loop over T, one multiply
  then one add per step (the plain version of the reference's
  ``kernels/ref.py`` ``linear_recurrence_ref``, which is an associative
  scan: the two round differently, within the reference's kernel
  tolerance atol 1e-5, rtol 1e-4): what ``ops`` runs on the CPU;
* :func:`linear_recurrence_chunked_plain` — the chunked route's algorithm
  (off every path; the tests hold it against the oracle);
* :func:`rglru_scan_cuda` — the Hopper kernels of ``csrc/rglru.cu``.  They
  replace the JAX package's Pallas kernel ``kernels/rglru_scan.py``
  (``rglru_scan`` / ``_rglru_kernel``).  Two routes, picked by
  :func:`rglru_route` from the shape alone:

  - ``"sequential"`` (decode, short T): a thread per (batch, channel) with
    a loop over T and every operation rounded on its own, so it equals
    :func:`linear_recurrence_plain` bit for bit.  On the H100 a decode
    step is bound by launch latency, a prefill by the serial loop (2,560
    threads for one RecurrentGemma-2B prompt);
  - ``"chunked"`` (prefill): T cut into chunks of :data:`CHUNK` steps, a
    thread per (batch, chunk, channel) in two launches — each chunk's
    product of a and its h from 0, then each chunk's incoming carry folded
    from those summaries and its h recomputed from it — so a prefill fills
    the card.  Its bytes bound it on the H100 (a and b read twice, the
    second time mostly from L2).  It equals
    :func:`linear_recurrence_chunked_plain` bit for bit; against the
    sequential order it is held to the reference's tolerance for its own
    log-depth scan (atol 1e-5, rtol 1e-4), not bit for bit.

The RG-LRU layer's gates, fused with the recurrence (the decode step of
``models/blocks.py`` ``rglru_apply``), from the conv output ``xc`` and the
two block-diagonal products before their biases (all (B, T, W), the
weights' type), the biases and ``lam`` (W,), and the carry h0:

* :func:`rglru_gates` — the layer's chain from those inputs to ``(a,
  bt)``, the reference's operations in its order (sigmoids, softplus,
  ``log_a``, ``beta``), each rounded to the type the chain gives it;
  :func:`rglru_gated_plain` is it followed by
  :func:`linear_recurrence_plain`;
* :func:`rglru_gated_cuda` — route ``"gated"`` of ``csrc/rglru.cu``: one
  launch computes the chain and the recurrence, a thread per (batch,
  channel) with a loop over T, and writes hT where it is told (a serving
  slot's state, in place).  It uses the single-precision functions and
  roundings of PyTorch's CUDA operators, so it is held to
  :func:`rglru_gated_plain` on the card bit for bit where they agree, and
  within the recurrence's tolerance in any case.  A decode step is bound
  by launch latency on the H100; the route takes the chain's 18 host
  operators a layer, and the copy of hT into the slot, out of a step that
  the host bounds.

:func:`rglru_scan` takes the JAX package's name and keywords and goes
through ``kernels.ops``.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from . import cuda_lib

__all__ = ["rglru_scan", "linear_recurrence_plain",
           "linear_recurrence_chunked_plain", "rglru_scan_cuda",
           "rglru_route", "rglru_gates", "rglru_gated_plain",
           "rglru_gated_cuda", "CHUNK", "CHUNKED_MIN_T"]

CHUNK = 32           # steps of a chunk on the chunked route
CHUNKED_MIN_T = 128  # shortest T sent to the chunked route (measured, PERF.md)
ROUTES = ("sequential", "chunked")
_LRU_C = 8.0         # the RG-LRU's decay scale (the reference's _LRU_C)
_GATED_DTYPES = (torch.float32, torch.bfloat16)


def rglru_route(B: int, T: int, W: int) -> str:
    """The route a call of this shape takes on the card: ``"chunked"`` for
    a prefill of at least :data:`CHUNKED_MIN_T` steps, else
    ``"sequential"``."""
    del B, W            # the threshold held for 1 and 4 requests
    return "chunked" if T >= CHUNKED_MIN_T else "sequential"


def _step(a, h, b):
    return torch.add(torch.mul(a, h), b)                  # two roundings


def linear_recurrence_plain(a, b, h0) -> Tuple[torch.Tensor, torch.Tensor]:
    af, bf = a.float(), b.float()
    h = h0.float()
    out = torch.empty(af.shape, dtype=torch.float32, device=af.device)
    for t in range(af.shape[1]):
        h = _step(af[:, t], h, bf[:, t])
        out[:, t] = h
    return out, h


def linear_recurrence_chunked_plain(a, b, h0
                                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The chunked route's algorithm, with the kernel's roundings: per
    chunk of :data:`CHUNK` steps the product of a and h from 0 (each
    operation rounded on its own), the carries folded over the chunks in
    order from h0, then h recomputed in each chunk from its carry."""
    af, bf = a.float(), b.float()
    B, T, W = af.shape
    if T == 0:
        return torch.empty((B, 0, W), device=af.device), h0.float().clone()
    nc = -(-T // CHUNK)
    pad = nc * CHUNK - T                 # a = 1, b = 0: exact no-op steps
    ac = torch.cat([af, torch.ones((B, pad, W), device=af.device)], 1)
    bc = torch.cat([bf, torch.zeros((B, pad, W), device=af.device)], 1)
    ac = ac.reshape(B, nc, CHUNK, W)
    bc = bc.reshape(B, nc, CHUNK, W)
    prod = torch.ones((B, nc, W), dtype=torch.float32, device=af.device)
    h_end = torch.zeros((B, nc, W), dtype=torch.float32, device=af.device)
    for t in range(CHUNK):
        h_end = _step(ac[:, :, t], h_end, bc[:, :, t])
        prod = torch.mul(prod, ac[:, :, t])
    h = h0.float()
    carry = []
    for c in range(nc):
        carry.append(h)
        h = _step(prod[:, c], h, h_end[:, c])
    h = torch.stack(carry, 1)
    out = torch.empty((B, nc, CHUNK, W), dtype=torch.float32,
                      device=af.device)
    for t in range(CHUNK):
        h = _step(ac[:, :, t], h, bc[:, :, t])
        out[:, :, t] = h
    out = out.reshape(B, nc * CHUNK, W)[:, :T]
    return out, out[:, -1].clone()


def rglru_scan_cuda(a, b, h0, *, route: Optional[str] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The CUDA kernels: same function as :func:`linear_recurrence_plain`
    (bit for bit on the sequential route).  Takes fp32 contiguous tensors;
    ``route`` defaults to :func:`rglru_route` of the shape.  Launches on
    the current stream (the chunked route's scratch from ``torch.empty``);
    raises on a refused launch."""
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
    if route is None:
        route = rglru_route(B, T, W)
    if route not in ROUTES:
        raise ValueError(f"unknown route {route!r}, not one of {ROUTES}")
    h = torch.empty((B, T, W), dtype=torch.float32, device=a.device)
    hT = torch.empty((B, W), dtype=torch.float32, device=a.device)
    lib = cuda_lib.load_library("rglru")
    stream = torch.cuda.current_stream(a.device).cuda_stream
    if route == "sequential":
        rc = lib.repro_rglru_scan_f32(a.data_ptr(), b.data_ptr(),
                                      h0.data_ptr(), h.data_ptr(),
                                      hT.data_ptr(), B, T, W, stream)
    else:
        # per (batch, chunk, channel): the product of a, then h from 0
        nc = max(1, -(-T // CHUNK))
        summary = torch.empty((2, B, nc, W), dtype=torch.float32,
                              device=a.device)
        rc = lib.repro_rglru_scan_chunked_f32(
            a.data_ptr(), b.data_ptr(), h0.data_ptr(), h.data_ptr(),
            hT.data_ptr(), summary.data_ptr(), B, T, W, CHUNK, stream)
    if rc != 0:
        raise RuntimeError(f"rglru_scan kernel launch failed ({route}): CUDA "
                           f"error {rc}")
    return h, hT


def rglru_scan(a, b, h0, *, block_t: int = 128, block_w: int = 512,
               interpret: bool = True) -> Tuple[torch.Tensor, torch.Tensor]:
    """The reference's entry point: ``kernels.ops.linear_recurrence``.
    ``block_t`` and ``block_w`` only tiled the reference's Pallas kernel
    and ``interpret`` ran it off a TPU; the kernels here pick their own
    route from the shape and the device of the data picks the version, so
    all three are accepted and ignored."""
    del block_t, block_w, interpret
    from . import ops
    return ops.linear_recurrence(a, b, h0)


def _softplus(x):
    # jax.nn.softplus is logaddexp(x, 0) for every input; F.softplus
    # switches to x above a threshold
    return torch.logaddexp(x, torch.zeros_like(x))


def rglru_gates(xc, rg_pre, ig_pre, rg_b, ig_b, lam
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The RG-LRU's gate chain, ``(a, bt)`` in fp32: the reference's
    ``rglru_apply`` from its two block-diagonal products (their bias adds,
    ``src/repro/models/blocks.py:478``) to ``bt`` (``:490-496``)."""
    rg = torch.sigmoid(rg_pre + rg_b)
    ig = torch.sigmoid(ig_pre + ig_b)
    log_a = -_LRU_C * _softplus(lam) * rg.float()
    a = torch.exp(log_a)
    gated_x = (ig * xc).float()
    beta = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-12))
    bt = beta * gated_x
    return a, bt


def rglru_gated_plain(xc, rg_pre, ig_pre, rg_b, ig_b, lam, h0
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`rglru_gates` then :func:`linear_recurrence_plain`."""
    a, bt = rglru_gates(xc, rg_pre, ig_pre, rg_b, ig_b, lam)
    return linear_recurrence_plain(a, bt, h0)


def rglru_gated_cuda(xc, rg_pre, ig_pre, rg_b, ig_b, lam, h0, *,
                     state_out: Optional[torch.Tensor] = None
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Route ``"gated"``: the same function as :func:`rglru_gated_plain` in
    one launch.  ``xc``, ``rg_pre``, ``ig_pre`` (B, T, W) and ``rg_b``,
    ``ig_b``, ``lam`` (W,) are one type, fp32 or bf16; h0 (B, W) fp32.
    hT goes to ``state_out`` when given (fp32 (B, W), contiguous; it may
    be h0) and is returned as it.  Launches on the current stream; raises
    on a refused launch."""
    xs = (xc, rg_pre, ig_pre)
    ws = (rg_b, ig_b, lam)
    out = [state_out] if state_out is not None else []
    tensors = list(xs + ws) + [h0] + out
    if not all(t.is_cuda and t.device == xc.device for t in tensors):
        raise ValueError("rglru_gated_cuda needs every tensor on one CUDA "
                         "device")
    if xc.dtype not in _GATED_DTYPES or any(t.dtype != xc.dtype
                                            for t in xs + ws):
        raise TypeError("rglru_gated_cuda takes xc, the gate products, the "
                        "biases and lam of one type, fp32 or bf16, got "
                        f"{[t.dtype for t in xs + ws]}")
    if any(t.dtype != torch.float32 for t in [h0] + out):
        raise TypeError("rglru_gated_cuda takes fp32 h0 and state_out")
    if xc.dim() != 3:
        raise ValueError(f"xc must be (B, T, W), got {tuple(xc.shape)}")
    B, T, W = xc.shape
    if (any(t.shape != xc.shape for t in xs)
            or any(t.shape != (W,) for t in ws)
            or any(t.shape != (B, W) for t in [h0] + out)):
        raise ValueError("shapes " + ", ".join(
            str(tuple(t.shape)) for t in tensors) + " are not (B, T, W) x3, "
            "(W,) x3 and (B, W)")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("rglru_gated_cuda takes contiguous tensors")
    if xc.numel() >= 2**62 or max(xc.shape) >= 2**31:
        raise ValueError(f"shape {tuple(xc.shape)} is too large")
    h = torch.empty((B, T, W), dtype=torch.float32, device=xc.device)
    hT = state_out if state_out is not None else torch.empty(
        (B, W), dtype=torch.float32, device=xc.device)
    lib = cuda_lib.load_library("rglru")
    stream = torch.cuda.current_stream(xc.device).cuda_stream
    rc = lib.repro_rglru_gated(
        *(t.data_ptr() for t in xs + ws), h0.data_ptr(), h.data_ptr(),
        hT.data_ptr(), B, T, W, int(xc.dtype == torch.bfloat16), stream)
    if rc != 0:
        raise RuntimeError(f"rglru_gated kernel launch failed: CUDA error "
                           f"{rc}")
    return h, hT
