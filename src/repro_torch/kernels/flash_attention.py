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
``decode_attention``).  The CUDA versions launch the Hopper kernels of
``csrc/attention.cu``, which replace the JAX package's Pallas kernels in
``src/repro/kernels/flash_attention.py`` (``flash_attention``, def :78,
and ``flash_decode``, def :162).  What bounds them on the H100 and what
their design does about it:

* Prefill is bound by operations (~4 hd flops a (row, key) pair).  A bf16
  call whose head dims are multiples of 16 up to 256 — every served shape
  — takes the tensor-core instance (:func:`attention_route` says
  ``"wgmma"``): both products on ``wgmma`` (bf16 in, fp32 accumulate, P
  rounded to bf16 before P V), K/V tiles of 64 keys brought by TMA into a
  two-stage ring by a producer warp, 64 query rows of one head a consumer
  warpgroup.  An fp32 call whose head dims are multiples of 8 up to 256 —
  every training shape — takes the 3xTF32 instance (``"tf32x3"``): both
  products as ``mma.sync`` m16n8k8 on the TF32 tensor cores, each operand
  split in a TF32 high part and a TF32 remainder and three products summed
  in fp32, so the result keeps fp32's accuracy; K/V tiles of 32 or 64 keys
  through a two-stage ``cp.async`` ring, blocks of 128, 64 or 32 query
  rows by the size of the grid (:func:`tf32x3_tile`).  Every other call
  (mixed types, other head dims) takes the CUDA-core instance
  (``"cuda_cores"``: fp32 FMAs, 32-key tiles).  A prompt row the masks
  leave with no key attends to every key with equal weight, as in the
  reference, whose mask is a finite -1e30.
* Decode is bound by bytes (the valid cache, read once per KV head).
  Blocks of 256 threads a (request, KV head, key split), sized by
  :func:`_decode_split` to put two blocks on every SM; the cache stays in
  its own type in shared memory, in chunks of 32 keys through a two-stage
  ``cp.async`` ring.  A bf16 cache whose head dims it takes — every served
  shape — goes to the tensor-core instance (:func:`decode_route` says
  ``"mma"``): ``mma.sync`` with the group's query heads as the rows of a
  tile, an fp32 q as two bf16 parts, P rounded to bf16; every other call
  to the CUDA-core one (``"cuda_cores"``: 8 lanes a key, q fp32).  A
  second kernel combines the splits when there is more than one.

Row statistics and accumulators are fp32, the output has q's type; the
kernels agree with the plain versions within the reference's kernel
tolerances (fp32 2e-5, bf16 2e-2).

:func:`flash_attention` and :func:`flash_decode` take the JAX package's
names and keywords and go through ``kernels.ops``, so the tensor's device
picks the version.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from ..models.layers import chunked_attention, decode_attention
from . import cuda_lib

__all__ = ["flash_attention", "flash_decode", "flash_attention_plain",
           "flash_attention_cuda",
           "flash_decode_plain", "flash_decode_cuda", "attention_route",
           "decode_route", "attention_instance", "decode_instance",
           "tf32x3_tile", "MAX_HEAD_DIM"]

MAX_HEAD_DIM = 256
MAX_DECODE_GROUP = 64      # query heads per KV head in one decode block
_DECODE_CHUNK = 32         # keys a decode chunk in csrc/attention.cu
_DECODE_BLOCKS_PER_SM = 2  # 256-thread decode blocks resident on an SM
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


def attention_route(q, k, v) -> str:
    """The prefill instance a call takes, by types and head dims alone:
    ``"wgmma"`` (tensor cores, bf16) for bf16 q, k and v whose head dims
    are multiples of 16 up to 256, ``"tf32x3"`` (tensor cores, 3xTF32) for
    fp32 q, k and v whose head dims are multiples of 8 up to 256, else
    ``"cuda_cores"``."""
    dims = (q.shape[-1], v.shape[-1])
    if q.dtype == k.dtype == v.dtype == torch.bfloat16 and all(
            d % 16 == 0 and 0 < d <= MAX_HEAD_DIM for d in dims):
        return "wgmma"
    if q.dtype == k.dtype == v.dtype == torch.float32 and all(
            d % 8 == 0 and 0 < d <= MAX_HEAD_DIM for d in dims):
        return "tf32x3"
    return "cuda_cores"


#: SMs of an H100, the card the instances are tuned for (and what the
#: instance of a call on a tensor off the card is named for)
H100_SMS = 132
_BLOCK_SMEM = 232448       # shared memory a block may use (227 KB)


def tf32x3_tile(B: int, Tq: int, H: int, hd: int, hdv: int,
                sms: int = H100_SMS) -> Tuple[int, int]:
    """(query rows a block, keys a K/V tile) of the 3xTF32 instance for a
    call on a card of ``sms`` SMs.  128 rows (4 warps of 32) where hdv <=
    64 and the grid holds at least 1.5 blocks an SM; else 64 rows (8
    warps, two a 16-row group, each taking half of every tile's keys)
    where it holds at least 2 blocks an SM; else 32 rows (8 warps, four a
    group, a quarter of the keys each), so a small grid still spreads over
    the card.  (The two thresholds are where the H100 measured the larger
    block ahead at the training shapes.)  Keys: 64 where Q and two stages
    of K and V, row pitches hd + 4 and hdv + 4 floats, fit in a block's
    227 KB, else 32."""
    blocks = B * H
    if hdv <= 64 and 2 * -(-Tq // 128) * blocks >= 3 * sms:
        rows = 128
    elif -(-Tq // 64) * blocks >= 2 * sms:
        rows = 64
    else:
        rows = 32
    smem = 4 * (rows * (hd + 4) + 2 * 64 * (hd + hdv + 8))
    return rows, 64 if smem <= _BLOCK_SMEM else 32


def _sms(t) -> int:
    if t.is_cuda:
        return torch.cuda.get_device_properties(t.device).multi_processor_count
    return H100_SMS


def decode_route(q, k_cache, v_cache) -> str:
    """The decode instance a call takes, by types and head dims alone:
    ``"mma"`` (tensor cores) for a bf16 cache with hd a multiple of 16 and
    hdv a multiple of 8 (q fp32 or bf16), else ``"cuda_cores"``."""
    bf16 = k_cache.dtype == v_cache.dtype == torch.bfloat16
    return ("mma" if bf16 and q.shape[-1] % 16 == 0
            and v_cache.shape[-1] % 8 == 0 else "cuda_cores")


def attention_instance(q, k, v) -> str:
    """The prefill kernel a call launches: ``"wgmma<NVP>"``, the bf16
    tensor-core instance with NVP 64-column V panels
    (``attn_wgmma_kernel<NVP>``); ``"tf32x3<NACC,KT,ROWS>"``, the 3xTF32
    instance with NACC O registers a thread (32 for hdv <= 64, 64 for <=
    128, else 128), KT-key tiles and ROWS-row blocks
    (``attn_tf32x3_kernel<NACC, KT, ROWS>``, :func:`tf32x3_tile` for the
    card q lies on, an H100 off it); or ``"cuda_cores"``."""
    route = attention_route(q, k, v)
    hdv = v.shape[-1]
    if route == "wgmma":
        return f"wgmma<{min(4, -(-hdv // 64))}>"
    if route == "tf32x3":
        B, Tq, H, hd = q.shape
        rows, keys = tf32x3_tile(B, Tq, H, hd, hdv, _sms(q))
        nacc = 32 if hdv <= 64 else 64 if hdv <= 128 else 128
        return f"tf32x3<{nacc},{keys},{rows}>"
    return route


def decode_instance(q, k_cache, v_cache) -> str:
    """The decode kernel a call launches: ``"mma<MT>"``, the tensor-core
    instance with MT 16-row tiles of a KV head's query group
    (``decode_mma_kernel<TQ, MT>``, MT 1, 2 or 4), or ``"cuda_cores"``."""
    route = decode_route(q, k_cache, v_cache)
    if route != "mma":
        return route
    mt = -(-(q.shape[-2] // k_cache.shape[-2]) // 16)
    return f"mma<{mt if mt <= 2 else 4}>"


_INSTANCE_ARG = {"cuda_cores": 0, "wgmma": 1, "tf32x3": 2}


def flash_attention_cuda(q, k, v, *, causal: bool = True, window: int = 0,
                         q_offset: int = 0, scale: Optional[float] = None,
                         route: Optional[str] = None):
    """The CUDA kernel: same function as :func:`flash_attention_plain`.
    Launches the instance :func:`attention_route` names on the current
    stream (``route`` forces one: ``"cuda_cores"`` takes every call, the
    tensor-core ones only theirs); raises on a call the instance does not
    take or a refused launch."""
    _check("flash_attention_cuda", q, k, v, 4)
    route = attention_route(q, k, v) if route is None else route
    if route not in _INSTANCE_ARG:
        raise ValueError(f"unknown attention route {route!r}")
    B, Tq, H, hd = q.shape
    Tk, Hkv, hdv = k.shape[1], k.shape[2], v.shape[-1]
    rows, keys = (tf32x3_tile(B, Tq, H, hd, hdv, _sms(q))
                  if route == "tf32x3" else (0, 0))
    scale = scale if scale is not None else 1.0 / math.sqrt(hd)
    out = torch.empty((B, Tq, H, hdv), dtype=q.dtype, device=q.device)
    lib = cuda_lib.load_library("attention")
    stream = torch.cuda.current_stream(q.device).cuda_stream
    rc = lib.repro_flash_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        int(q.dtype == torch.bfloat16), int(k.dtype == torch.bfloat16),
        _INSTANCE_ARG[route], rows, keys, B, Tq, Tk, H, Hkv, hd, hdv,
        int(bool(causal)), int(window), int(q_offset), float(scale), stream)
    if rc != 0:
        raise RuntimeError(f"flash_attention kernel launch failed ({route}): "
                           f"CUDA error {rc} (below 0: minus the driver's "
                           f"CUresult for a refused tensor map)")
    return out


def _decode_split(groups: int, S: int, sms: int):
    """(number of key splits, keys per split) for a decode over ``groups``
    (request, KV head) pairs and ``S`` cache slots on a card of ``sms``
    SMs: enough splits for two 256-thread blocks on every SM, each a whole
    number of 32-key chunks, and no split past the last slot."""
    target = _DECODE_BLOCKS_PER_SM * sms
    nsplit = max(1, min(-(-S // _DECODE_CHUNK), -(-target // max(1, groups))))
    split_keys = -(-max(S, 1) // nsplit)
    split_keys = -(-split_keys // _DECODE_CHUNK) * _DECODE_CHUNK
    return -(-max(S, 1) // split_keys), split_keys


def flash_decode_cuda(q, k_cache, v_cache, cur_len, *,
                      scale: Optional[float] = None):
    """The CUDA kernel: same function as :func:`flash_decode_plain`.
    ``cur_len`` is an int, a 0-d or a (B,) integer tensor.  Launches the
    instance :func:`decode_route` names on the current stream; raises on a
    refused launch."""
    _check("flash_decode_cuda", q, k_cache, v_cache, 3)
    B, H, hd = q.shape
    S, Hkv, hdv = k_cache.shape[1], k_cache.shape[2], v_cache.shape[-1]
    scale = scale if scale is not None else 1.0 / math.sqrt(hd)
    lens = torch.as_tensor(cur_len, device=q.device).to(torch.int64)
    if lens.dim() == 0:
        lens = lens.expand(B)
    if lens.shape != (B,):
        raise ValueError(f"cur_len must be a scalar or ({B},), got "
                         f"{tuple(lens.shape)}")
    if H // Hkv > MAX_DECODE_GROUP:
        raise ValueError(f"flash_decode_cuda takes at most "
                         f"{MAX_DECODE_GROUP} query heads per KV head")
    lens = lens.contiguous()
    sms = torch.cuda.get_device_properties(q.device).multi_processor_count
    nsplit, split_keys = _decode_split(B * Hkv, S, sms)
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
        int(decode_route(q, k_cache, v_cache) == "mma"), B, S, H, Hkv, hd,
        hdv, nsplit, split_keys, float(scale), stream)
    if rc != 0:
        raise RuntimeError(f"flash_decode kernel launch failed: CUDA error "
                           f"{rc}")
    return out


# The reference's ``block_q``, ``block_k`` and ``interpret`` only tiled its
# Pallas kernels on the TPU (or ran them interpreted off it); the Hopper
# kernels pick their own tiles, and the device of the data picks the
# version, so both entries accept them and ignore them.
def flash_attention(q, k, v, *, causal: bool = True, window: int = 0,
                    q_offset: int = 0, scale: Optional[float] = None,
                    block_q: int = 256, block_k: int = 512,
                    interpret: bool = True):
    """The reference's entry point: ``kernels.ops.flash_attention``."""
    del block_q, block_k, interpret
    from . import ops
    return ops.flash_attention(q, k, v, causal=causal, window=window,
                               q_offset=q_offset, scale=scale)


def flash_decode(q, k_cache, v_cache, cur_len, *,
                 scale: Optional[float] = None, block_k: int = 512,
                 interpret: bool = True):
    """The reference's entry point: ``kernels.ops.flash_decode``."""
    del block_k, interpret
    from . import ops
    return ops.flash_decode(q, k_cache, v_cache, cur_len, scale=scale)
