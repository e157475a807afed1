"""The RWKV6 (Finch) WKV recurrence, plain and CUDA.

Per (batch, head), an fp32 (dk, dv) state S carried over T steps with a
data-dependent decay w and a bonus u::

    y_t = r_t . (S + diag(u) k_t v_t^T)
    S   = diag(w_t) S + k_t v_t^T

Layouts are the reference's: r, k, w (B, T, H, dk); v (B, T, H, dv); u
(H, dk); s0 (B, H, dk, dv) fp32.  Both versions return ``(y (B, T, H, dv),
sT (B, H, dk, dv))`` in fp32.

* :func:`wkv6_plain` — the sequential recurrence of the reference's oracle
  (``kernels/ref.py`` ``wkv6_ref``) as a loop over T, in fp32;
* :func:`wkv6_cuda` — the Hopper kernel of ``csrc/wkv6.cu``, the same
  sequential recurrence with the sum over dk taken in another order, so the
  two agree within the reference's kernel tolerance (atol = rtol = 1e-4).
  It replaces the JAX package's Pallas kernel ``kernels/rwkv6_scan.py``
  (``wkv6`` / ``_wkv_kernel``), whose chunked rescaling overflows for
  decays near 0; the sequential form has no such limit.

``state_out``, where given, is an fp32 (B, H, dk, dv) tensor that receives
sT and is returned as it: it may be ``s0`` itself, so that a serving
slot's state is updated in place with no copy.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from . import cuda_lib

__all__ = ["wkv6_plain", "wkv6_cuda", "MAX_DIM"]

MAX_DIM = 128        # largest dk and dv the kernel takes
_DTYPES = (torch.float32, torch.bfloat16)


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
    if state_out is not None:
        state_out.copy_(s)
        s = state_out
    return y, s


def wkv6_cuda(r, k, v, w, u, s0, *, state_out: Optional[torch.Tensor] = None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The CUDA kernel: same function as :func:`wkv6_plain`.  r, k and v
    are one type, fp32 or bf16 (read as they are); w and s0 fp32; u is cast
    to fp32 here.  Launches on the current stream; raises on a refused
    launch."""
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
    rc = lib.repro_wkv6(r.data_ptr(), k.data_ptr(), v.data_ptr(),
                        w.data_ptr(), uf.data_ptr(), s0.data_ptr(),
                        y.data_ptr(), sT.data_ptr(),
                        int(r.dtype == torch.bfloat16), B, T, H, dk, dv,
                        stream)
    if rc != 0:
        raise RuntimeError(f"wkv6 kernel launch failed: CUDA error {rc}")
    return y, sT
