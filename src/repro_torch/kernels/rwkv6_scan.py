"""The RWKV6 (Finch) WKV recurrence, plain and CUDA.

Per (batch, head), an fp32 (dk, dv) state S carried over T steps with a
data-dependent decay w and a bonus u::

    y_t = r_t . (S + diag(u) k_t v_t^T)
    S   = diag(w_t) S + k_t v_t^T

Layouts are the reference's: r, k, w (B, T, H, dk); v (B, T, H, dv); u
(H, dk); s0 (B, H, dk, dv) fp32.  Every version returns ``(y (B, T, H,
dv), sT (B, H, dk, dv))`` in fp32.

* :func:`wkv6_plain` — the sequential recurrence of the reference's oracle
  (``kernels/ref.py`` ``wkv6_ref``) as a loop over T, in fp32: what ``ops``
  runs on the CPU;
* :func:`wkv6_chunked_plain` — the chunked algorithm of the card's
  ``"chunked"`` route in fp32 (off every path; the tests hold it against
  the oracle);
* :func:`wkv6_cuda` — the Hopper kernels of ``csrc/wkv6.cu``.  They replace
  the JAX package's Pallas kernel ``kernels/rwkv6_scan.py`` (``wkv6`` /
  ``_wkv_kernel``), which runs chunks of 32 as MXU products of
  ``r exp(la_prev)`` and ``k exp(-la)`` (``la`` the cumulative log decay
  from the chunk's start); ``exp(-la)`` overflows fp32 within a chunk once
  decays fall below ~0.06.  Two routes, picked by :func:`wkv6_route` from
  the shape alone:

  - ``"sequential"`` (decode, short T, dk or dv above 64 or not a
    multiple of 8): the exact sequential recurrence, a block per (batch,
    head, state-column tile).  On the H100 the state's bytes bound it in
    decode; in a long prefill the serial chain over T does, with one warp
    per scheduler for one request;
  - ``"chunked"`` (prefill): chunks of :data:`CHUNK` steps worked on in
    parallel, so that chunks × heads fill the card (1,472 blocks for one
    RWKV6-7B prompt of 1,428 tokens), in three launches — each chunk's own
    state contribution and total decay, a prefix over chunks from s0 (it
    reads all of s0 before it writes sT), then each chunk's outputs from
    its incoming state.  Every decay factor is a product of w's normalised
    at the boundary of :data:`SUB`-step sub-chunks, so none exceeds 1 and
    small decays underflow to 0, their limit, instead of overflowing.  The
    products run on the tensor cores in TF32 with the 3xTF32 split (hi·hi
    + hi·lo + lo·hi, fp32 accumulation), since one TF32 product misses the
    1e-4 tolerance by an order of magnitude.  On the H100 the bytes bound
    it (r, k, v, w read twice, y written, the per-chunk states written,
    read and written by the prefix, read again), then the elementwise
    sub-chunk diagonals and the mma.sync products.

  Both agree with :func:`wkv6_plain` within the reference's kernel
  tolerance (atol = rtol = 1e-4): they sum in other orders.

``state_out``, where given, is an fp32 (B, H, dk, dv) tensor that receives
sT and is returned as it: it may be ``s0`` itself, so that a serving
slot's state is updated in place with no copy.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from . import cuda_lib

__all__ = ["wkv6_plain", "wkv6_chunked_plain", "wkv6_cuda", "wkv6_route",
           "MAX_DIM", "CHUNK", "SUB", "CHUNKED_MAX_DIM", "CHUNKED_MIN_T"]

MAX_DIM = 128        # largest dk and dv the kernels take
# the chunked route's tiles, as csrc/wkv6.cu fixes them (kC, kL, kD): the
# wrapper sizes the kernels' scratch from them
CHUNK = 64           # steps of a chunk
SUB = 16             # steps of a sub-chunk (one 16-row tensor-core tile)
CHUNKED_MAX_DIM = 64  # largest dk and dv
CHUNKED_MIN_T = 64   # shortest T sent to the chunked route (measured, PERF.md)
ROUTES = ("sequential", "chunked")
_DTYPES = (torch.float32, torch.bfloat16)


def _chunked_dims(dk: int, dv: int) -> bool:
    # the chunked kernels' tiles: rows of whole 16-byte loads, up to 64
    return all(d <= CHUNKED_MAX_DIM and d % 8 == 0 for d in (dk, dv))


def wkv6_route(B: int, T: int, H: int, dk: int, dv: int) -> str:
    """The route a call of this shape takes on the card: ``"chunked"`` for
    a prefill of at least :data:`CHUNKED_MIN_T` steps with dk and dv
    multiples of 8 up to :data:`CHUNKED_MAX_DIM`, else ``"sequential"``."""
    del B, H            # the threshold held for 1 and 4 requests of 64 heads
    if T >= CHUNKED_MIN_T and _chunked_dims(dk, dv):
        return "chunked"
    return "sequential"


def wkv6_plain(r, k, v, w, u, s0, *, state_out: Optional[torch.Tensor] = None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    rf, kf, vf, wf = (x.float() for x in (r, k, v, w))
    uf = u.float()[None, :, :, None]
    s = s0.float()
    B, T, H, _ = rf.shape
    y = torch.empty((B, T, H, vf.shape[-1]), dtype=torch.float32,
                    device=rf.device)
    for t in range(T):
        kv = kf[:, t, :, :, None] * vf[:, t, :, None, :]      # (B, H, dk, dv)
        y[:, t] = torch.einsum("bhk,bhkv->bhv", rf[:, t], s + uf * kv)
        s = wf[:, t, :, :, None] * s + kv
    return y, _store(s, state_out)


def _store(s, state_out):
    if state_out is None:
        return s
    state_out.copy_(s)
    return state_out


def _chunked(x, nc, fill):
    """(B, T, H, d) -> (B, H, nc, CHUNK // SUB, SUB, d) fp32, T padded
    with ``fill`` to nc chunks."""
    B, T, H, d = x.shape
    xf = x.float().transpose(1, 2)
    pad = torch.full((B, H, nc * CHUNK - T, d), fill, dtype=torch.float32,
                     device=x.device)
    return torch.cat([xf, pad], 2).reshape(B, H, nc, CHUNK // SUB, SUB, d)


def wkv6_chunked_plain(r, k, v, w, u, s0, *,
                       state_out: Optional[torch.Tensor] = None
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The chunked route's algorithm in fp32, as ``csrc/wkv6.cu`` runs it.

    In a chunk, step i of sub-chunk I sees key j through the product of
    the decays strictly between them.  With P_i the product of w from the
    start of I up to i - 1, Q_j the product of w after j up to the end of
    its sub-chunk J, Tot the product over a whole sub-chunk (all <= 1):

    * j in an earlier sub-chunk: (r_i P_i) . (k_j Q_j G_IJ), G_IJ the
      product of the Tot strictly between J and I (one tensor-core product
      a sub-chunk pair, normalised at the boundary before I);
    * j in I, j < i: sum_c r_ic k_jc prod_{j<m<i} w_mc, elementwise, the
      product kept as a running product; j = i: the bonus r_i . (u k_i);
    * the incoming state: (r_i P_i prod_{I'<I} Tot_I') . S_in;
    * the chunk's own state contribution: (k_j Q_j prod_{J'>J} Tot_J')^T
      v_j, and its total decay prod Tot; a prefix over chunks from s0 gives
      each chunk's S_in and sT.
    """
    B, T, H, dk = r.shape
    dv = v.shape[-1]
    dev = r.device
    n = CHUNK // SUB
    nc = -(-T // CHUNK)
    r6, k6, v6 = (_chunked(x, nc, 0.0) for x in (r, k, v))
    w6 = _chunked(w, nc, 1.0)
    one = torch.ones_like(w6[..., :1, :])
    cw = torch.cumprod(w6, 4)
    P = torch.cat([one, cw[..., :-1, :]], 4)               # prod start..i-1
    rc = torch.flip(torch.cumprod(torch.flip(w6, [4]), 4), [4])
    Q = torch.cat([rc[..., 1:, :], one], 4)                # prod j+1..end
    tot = cw[..., -1, :]                                   # (B, H, nc, n, dk)
    ones = torch.ones_like(tot[..., :1, :])
    before = torch.cat([ones, torch.cumprod(tot, 3)[..., :-1, :]], 3)
    after = torch.flip(torch.cumprod(torch.flip(tot, [3]), 3), [3])
    after = torch.cat([after[..., 1:, :], ones], 3)
    rh, kh = r6 * P, k6 * Q

    att = torch.zeros((B, H, nc, n, SUB, n, SUB), dtype=torch.float32,
                      device=dev)
    for i_sub in range(n):
        for j_sub in range(i_sub):
            g = torch.ones_like(tot[..., 0, :])
            for m in range(j_sub + 1, i_sub):
                g = g * tot[..., m, :]
            att[:, :, :, i_sub, :, j_sub] = torch.einsum(
                "...ic,...jc->...ij", rh[..., i_sub, :, :],
                kh[..., j_sub, :, :] * g[..., None, :])
    # the diagonal sub-chunks: f[j] = prod_{j<m<i} w_m for j < i
    f = torch.ones_like(w6)
    idx = torch.arange(SUB, device=dev)
    diag = torch.zeros((B, H, nc, n, SUB, SUB), dtype=torch.float32,
                       device=dev)
    for i in range(SUB):
        part = torch.einsum("...c,...jc->...j", r6[..., i, :], k6 * f)
        diag[..., i, :] = torch.where(idx < i, part, 0.0)
        f = f * torch.where((idx < i)[:, None], w6[..., i:i + 1, :], 1.0)
    bonus = (r6 * u.float()[None, :, None, None, None, :] * k6).sum(-1)
    diag = diag + torch.diag_embed(bonus)
    for s in range(n):
        att[:, :, :, s, :, s] = diag[..., s, :, :]
    att = att.reshape(B, H, nc, CHUNK, CHUNK)

    q = (rh * before[..., None, :]).reshape(B, H, nc, CHUNK, dk)
    kbar = (kh * after[..., None, :]).reshape(B, H, nc, CHUNK, dk)
    vc = v6.reshape(B, H, nc, CHUNK, dv)
    contrib = torch.einsum("...jc,...jd->...cd", kbar, vc)  # (.., dk, dv)
    decay = tot[..., 0, :]
    for m in range(1, n):
        decay = decay * tot[..., m, :]
    s = s0.float()
    s_in = []
    for c in range(nc):
        s_in.append(s)
        s = decay[:, :, c, :, None] * s + contrib[:, :, c]
    y = torch.einsum("...ij,...jd->...id", att, vc)
    if nc:
        y = y + torch.einsum("...ic,...cd->...id", q,
                             torch.stack(s_in, 2))
    y = y.reshape(B, H, nc * CHUNK, dv)[:, :, :T].transpose(1, 2)
    return y.contiguous(), _store(s, state_out)


def wkv6_cuda(r, k, v, w, u, s0, *, state_out: Optional[torch.Tensor] = None,
              route: Optional[str] = None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The CUDA kernels: same function as :func:`wkv6_plain`.  r, k and v
    are one type, fp32 or bf16 (read as they are); w and s0 fp32; u is cast
    to fp32 here.  ``route`` defaults to :func:`wkv6_route` of the shape.
    Launches on the current stream (the chunked route's scratch from
    ``torch.empty``); raises on a refused launch."""
    out = [state_out] if state_out is not None else []
    tensors = [r, k, v, w, u, s0] + out
    if not all(t.is_cuda and t.device == r.device for t in tensors):
        raise ValueError("wkv6_cuda needs every tensor on one CUDA device")
    if r.dtype not in _DTYPES or k.dtype != r.dtype or v.dtype != r.dtype:
        raise TypeError(f"wkv6_cuda takes r, k, v of one type, fp32 or bf16, "
                        f"got {r.dtype}, {k.dtype}, {v.dtype}")
    if any(t.dtype != torch.float32 for t in [w, s0] + out):
        raise TypeError("wkv6_cuda takes fp32 w, s0 and state_out")
    if r.dim() != 4:
        raise ValueError(f"r must be (B, T, H, dk), got {tuple(r.shape)}")
    B, T, H, dk = r.shape
    dv = v.shape[-1]
    state_shape = (B, H, dk, dv)
    if (k.shape != r.shape or w.shape != r.shape or v.shape != (B, T, H, dv)
            or u.shape != (H, dk) or s0.shape != state_shape
            or (state_out is not None and state_out.shape != state_shape)):
        raise ValueError(f"shapes r {tuple(r.shape)}, k {tuple(k.shape)}, v "
                         f"{tuple(v.shape)}, w {tuple(w.shape)}, u "
                         f"{tuple(u.shape)}, s0 {tuple(s0.shape)} do not fit")
    if not (0 < dk <= MAX_DIM and 0 < dv <= MAX_DIM):
        raise ValueError(f"wkv6_cuda takes dk and dv in 1..{MAX_DIM}, got "
                         f"{dk}, {dv}")
    if route is None:
        route = wkv6_route(B, T, H, dk, dv)
    if route not in ROUTES:
        raise ValueError(f"unknown route {route!r}, not one of {ROUTES}")
    if route == "chunked" and not _chunked_dims(dk, dv):
        raise ValueError(f"the chunked route takes dk and dv multiples of 8 "
                         f"up to {CHUNKED_MAX_DIM}, got {dk}, {dv}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("wkv6_cuda takes contiguous tensors")
    if (B > 65535 or H > 65535 or T >= 2**31
            or max(t.numel() for t in tensors) >= 2**62):
        raise ValueError(f"shape {tuple(r.shape)} is too large")
    uf = u.float().contiguous()
    y = torch.empty((B, T, H, dv), dtype=torch.float32, device=r.device)
    sT = state_out if state_out is not None else torch.empty(
        state_shape, dtype=torch.float32, device=r.device)
    lib = cuda_lib.load_library("wkv6")
    stream = torch.cuda.current_stream(r.device).cuda_stream
    ptrs = (r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
            uf.data_ptr(), s0.data_ptr(), y.data_ptr(), sT.data_ptr())
    bf16 = int(r.dtype == torch.bfloat16)
    if route == "sequential":
        rc = lib.repro_wkv6(*ptrs, bf16, B, T, H, dk, dv, stream)
    else:
        nc = -(-T // CHUNK)
        # per chunk: its state contribution, overwritten by its incoming
        # state, (D x D) with D = CHUNKED_MAX_DIM; and its total decay (D)
        D = CHUNKED_MAX_DIM
        states = torch.empty((B, H, nc, D, D), dtype=torch.float32,
                             device=r.device)
        decays = torch.empty((B, H, nc, D), dtype=torch.float32,
                             device=r.device)
        rc = lib.repro_wkv6_chunked(*ptrs, states.data_ptr(),
                                    decays.data_ptr(), bf16, B, T, H, dk, dv,
                                    stream)
    if rc != 0:
        raise RuntimeError(f"wkv6 kernel launch failed ({route}): CUDA "
                           f"error {rc}")
    return y, sT
