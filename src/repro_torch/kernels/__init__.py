"""repro_torch.kernels — a plain PyTorch version of each kernel beside its
Hopper CUDA kernel (``csrc/``: ``alloc.cu`` for the allocation path,
``attention.cu``, ``rglru.cu`` and ``wkv6.cu`` for the model path), the
device dispatch in :mod:`repro_torch.kernels.ops`, and the oracles under
the JAX package's names in :mod:`repro_torch.kernels.ref`."""
from . import ops, ref

__all__ = ["ops", "ref"]
