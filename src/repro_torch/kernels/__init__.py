"""repro_torch.kernels — a plain PyTorch version of each kernel beside its
Hopper CUDA kernel (``csrc/``: ``alloc.cu`` for the allocation path,
``attention.cu``, ``rglru.cu`` and ``wkv6.cu`` for the serving path), and
the device dispatch in :mod:`repro_torch.kernels.ops`."""
