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
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from . import cuda_lib

__all__ = ["linear_recurrence_plain", "linear_recurrence_chunked_plain",
           "rglru_scan_cuda", "rglru_route", "CHUNK", "CHUNKED_MIN_T"]

CHUNK = 32           # steps of a chunk on the chunked route
CHUNKED_MIN_T = 128  # shortest T sent to the chunked route (measured, PERF.md)
ROUTES = ("sequential", "chunked")


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
