"""The per-node usage scatter of the §4.7 stretch passes, plain and CUDA.

For every lane ``b``, ``out[b, n]`` is the sum of ``vals[b, k]`` over the
entries with ``nodes[b, k] == n``, added in ascending ``k`` from ``0.0``:
bit for bit the in-order ``np.add.at`` accumulation of the stretch passes
(``core/stretch_opt.py``).  The sentinel ``n_nodes`` marks padding; it
and every other entry outside ``[0, n_nodes)`` are dropped, as the JAX
package's ``segment_sum`` drops them.

* :func:`node_usage_plain` walks the list one column at a time: a column
  names one node a lane, so no two of its adds meet, and every node's
  adds run in list order;
* :func:`node_usage_cuda` launches the Hopper kernel of ``csrc/alloc.cu``
  (``node_usage_kernel``), which replaces the XLA ``segment_sum`` of the
  JAX package's ``core/alloc_jax.py`` (``node_usage`` /
  ``node_usage_batch``).  ``index_add_`` and ``scatter_add_`` add with
  atomics on the card, in an order that changes from run to run, so the
  kernel has one thread a node walk the lane's list in order instead.
  It is bound by bytes, and at the passes' sizes by the walk's latency.
"""
from __future__ import annotations

import torch

from ..device import BackendFault
from . import cuda_lib

__all__ = ["node_usage_plain", "node_usage_cuda"]


def node_usage_plain(nodes: torch.Tensor, vals: torch.Tensor,
                     n_nodes: int) -> torch.Tensor:
    """In-order per-node sums in plain PyTorch.

    nodes: (B, K) int64; vals: (B, K) float64.  Returns (B, n_nodes).
    """
    B, K = vals.shape
    n = int(n_nodes)
    # one extra column swallows the dropped entries
    out = torch.zeros((B, n + 1), dtype=vals.dtype, device=vals.device)
    idx = torch.where((nodes >= 0) & (nodes < n), nodes,
                      torch.full_like(nodes, n))
    lanes = torch.arange(B, device=vals.device)
    for k in range(K):
        out[lanes, idx[:, k]] += vals[:, k]
    return out[:, :n]


def _check(nodes: torch.Tensor, vals: torch.Tensor, n_nodes: int) -> None:
    if not (nodes.is_cuda and vals.is_cuda and nodes.device == vals.device):
        raise ValueError("node_usage_cuda needs both tensors on one CUDA "
                         "device")
    if nodes.dtype != torch.int64 or vals.dtype != torch.float64:
        raise TypeError("node_usage_cuda takes int64 nodes and float64 "
                        f"values, got {nodes.dtype} and {vals.dtype}")
    if vals.dim() != 2 or nodes.shape != vals.shape:
        raise ValueError(f"shapes {tuple(nodes.shape)} and "
                         f"{tuple(vals.shape)} are not both (B, K)")
    if not (nodes.is_contiguous() and vals.is_contiguous()):
        raise ValueError("node_usage_cuda takes contiguous tensors")
    if not 0 <= int(n_nodes) < 2**31 or max(vals.shape) >= 2**31:
        raise ValueError(f"shape {tuple(vals.shape)} with {n_nodes} nodes "
                         "is out of range")


def node_usage_cuda(nodes: torch.Tensor, vals: torch.Tensor,
                    n_nodes: int) -> torch.Tensor:
    """The CUDA kernel: same function as :func:`node_usage_plain`, bit for
    bit.  Launches on the current stream; a build that fails or a launch
    that is refused raises :class:`~repro_torch.device.BackendFault`."""
    _check(nodes, vals, n_nodes)
    B, K = vals.shape
    out = torch.empty((B, int(n_nodes)), dtype=torch.float64,
                      device=vals.device)
    try:
        lib = cuda_lib.load_library("alloc")
    except (RuntimeError, OSError) as exc:  # no nvcc, a refused source
        raise BackendFault(f"node_usage kernel did not build: {exc}") from exc
    stream = torch.cuda.current_stream(vals.device).cuda_stream
    rc = lib.repro_node_usage_f64(nodes.data_ptr(), vals.data_ptr(),
                                  out.data_ptr(), B, K, int(n_nodes), stream)
    if rc != 0:
        raise BackendFault(f"node_usage kernel launch failed: CUDA error {rc}")
    return out
