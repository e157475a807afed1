"""Flash attention (prefill) and flash decode, plain and CUDA.

The serving path's two attention primitives:

* ``flash_attention(q, k, v)`` — GQA attention of a prompt, q (B, Tq, H,
  hd) against k/v (B, Tk, Hkv, hd/hdv), with causal and sliding-window
  masks and a ``q_offset``;
* ``flash_decode(q, k_cache, v_cache, cur_len)`` — one new token per
  request, q (B, H, hd), against a (ring-buffered) KV cache (B, S, Hkv,
  hd), valid below ``min(cur_len + 1, S)`` per request.

The plain versions are the reference's chunked oracles ported to PyTorch
(:func:`repro_torch.models.layers.chunked_attention` and
``decode_attention``).  The CUDA versions launch the Hopper kernel of
``csrc/attention.cu``, which replaces the JAX package's Pallas kernels
``kernels/flash_attention.py`` (``flash_attention`` / ``_attn_kernel`` and
``flash_decode`` / ``_decode_kernel``): fp32 softmax statistics and
accumulator, fp32 or bf16 inputs (q and the cache independently), output
in q's dtype; decode splits the cache over about one block per SM and
combines the splits in a second kernel.  Both agree within the
reference's kernel tolerances (fp32 2e-5, bf16 2e-2).
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from ..models.layers import chunked_attention, decode_attention
from . import cuda_lib

__all__ = ["flash_attention_plain", "flash_attention_cuda",
           "flash_decode_plain", "flash_decode_cuda", "MAX_HEAD_DIM"]

MAX_HEAD_DIM = 256
MAX_DECODE_GROUP = 64      # query heads per KV head in one decode block
_KEY_TILE = 32             # keys per tile in csrc/attention.cu
_DTYPES = (torch.float32, torch.bfloat16)


#: the plain versions: the chunked oracles of ``models/layers.py``
flash_attention_plain = chunked_attention
flash_decode_plain = decode_attention


def _check(name, q, k, v, q_dims):
    tensors = (q, k, v)
    if not all(t.is_cuda and t.device == q.device for t in tensors):
        raise ValueError(f"{name} needs q, k and v on one CUDA device")
    if q.dtype not in _DTYPES or k.dtype not in _DTYPES or k.dtype != v.dtype:
        raise TypeError(f"{name} takes fp32 or bf16 q and one fp32 or bf16 "
                        f"type for k and v, got {q.dtype}, {k.dtype}, "
                        f"{v.dtype}")
    if q.dim() != q_dims or k.dim() != 4 or v.dim() != 4:
        raise ValueError(f"{name}: bad ranks {q.dim()}, {k.dim()}, {v.dim()}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{name} takes contiguous tensors")
    B, Tk, Hkv, hd = k.shape
    H = q.shape[-2]
    if (q.shape[0] != B or q.shape[-1] != hd or v.shape[:3] != (B, Tk, Hkv)
            or Hkv == 0 or H % Hkv):
        raise ValueError(f"{name}: shapes {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)} do not fit")
    if not (0 < hd <= MAX_HEAD_DIM and 0 < v.shape[-1] <= MAX_HEAD_DIM):
        raise ValueError(f"{name} takes head dims 1..{MAX_HEAD_DIM}")
    if max(t.numel() for t in tensors) >= 2**62 or max(
            max(t.shape) for t in tensors) >= 2**31:
        raise ValueError(f"{name}: tensors too large")


def flash_attention_cuda(q, k, v, *, causal: bool = True, window: int = 0,
                         q_offset: int = 0, scale: Optional[float] = None):
    """The CUDA kernel: same function as :func:`flash_attention_plain`.
    Launches on the current stream; raises on a refused launch."""
    _check("flash_attention_cuda", q, k, v, 4)
    B, Tq, H, hd = q.shape
    Tk, Hkv, hdv = k.shape[1], k.shape[2], v.shape[-1]
    scale = scale if scale is not None else 1.0 / math.sqrt(hd)
    out = torch.empty((B, Tq, H, hdv), dtype=q.dtype, device=q.device)
    lib = cuda_lib.load_library("attention")
    stream = torch.cuda.current_stream(q.device).cuda_stream
    rc = lib.repro_flash_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        int(q.dtype == torch.bfloat16), int(k.dtype == torch.bfloat16),
        B, Tq, Tk, H, Hkv, hd, hdv, int(bool(causal)), int(window),
        int(q_offset), float(scale), stream)
    if rc != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: CUDA "
                           f"error {rc}")
    return out


def _decode_split(groups: int, G: int, S: int, device):
    """(number of key splits, keys per split) for a decode over ``groups``
    (request, KV head) pairs of ``G`` query heads each and ``S`` cache
    slots: enough splits to fill every SM, at least one key tile (32 keys)
    each.  A group of at most 16 heads runs in 64-thread blocks of which
    about four share an SM (``csrc/attention.cu``), a larger one in
    256-thread blocks, one an SM."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    target = sms * (4 if G <= 16 else 1)
    nsplit = max(1, min(-(-S // _KEY_TILE), -(-target // max(1, groups))))
    split_keys = -(-max(S, 1) // nsplit)
    split_keys = -(-split_keys // _KEY_TILE) * _KEY_TILE
    return -(-max(S, 1) // split_keys), split_keys


def flash_decode_cuda(q, k_cache, v_cache, cur_len, *,
                      scale: Optional[float] = None):
    """The CUDA kernel: same function as :func:`flash_decode_plain`.
    ``cur_len`` is an int, a 0-d or a (B,) integer tensor.  Launches on the
    current stream; raises on a refused launch."""
    _check("flash_decode_cuda", q, k_cache, v_cache, 3)
    B, H, hd = q.shape
    S, Hkv, hdv = k_cache.shape[1], k_cache.shape[2], v_cache.shape[-1]
    scale = scale if scale is not None else 1.0 / math.sqrt(hd)
    lens = torch.as_tensor(cur_len, device=q.device).to(torch.int32)
    if lens.dim() == 0:
        lens = lens.expand(B)
    if lens.shape != (B,):
        raise ValueError(f"cur_len must be a scalar or ({B},), got "
                         f"{tuple(lens.shape)}")
    if H // Hkv > MAX_DECODE_GROUP:
        raise ValueError(f"flash_decode_cuda takes at most "
                         f"{MAX_DECODE_GROUP} query heads per KV head")
    lens = lens.contiguous()
    nsplit, split_keys = _decode_split(B * Hkv, H // Hkv, S, q.device)
    out = torch.empty((B, H, hdv), dtype=q.dtype, device=q.device)
    part_acc = torch.empty((B, H, nsplit, hdv), dtype=torch.float32,
                           device=q.device)
    part_ml = torch.empty((B, H, nsplit, 2), dtype=torch.float32,
                          device=q.device)
    lib = cuda_lib.load_library("attention")
    stream = torch.cuda.current_stream(q.device).cuda_stream
    rc = lib.repro_flash_decode(
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), lens.data_ptr(),
        out.data_ptr(), part_acc.data_ptr(), part_ml.data_ptr(),
        int(q.dtype == torch.bfloat16), int(k_cache.dtype == torch.bfloat16),
        B, S, H, Hkv, hd, hdv, nsplit, split_keys, float(scale), stream)
    if rc != 0:
        raise RuntimeError(f"flash_decode kernel launch failed: CUDA error "
                           f"{rc}")
    return out
