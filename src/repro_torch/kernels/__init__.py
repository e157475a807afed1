"""repro_torch.kernels — the allocation path's kernels: a plain PyTorch
version of each beside its Hopper CUDA kernel (``csrc/alloc.cu``), and the
device dispatch in :mod:`repro_torch.kernels.ops`."""
