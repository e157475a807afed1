"""The chips' published peaks, by the name ``torch.cuda.get_device_name``
gives (NVIDIA's H100 SXM data sheet: dense rates, no sparsity, at the
full 700 W power limit)."""
PEAKS = {
    "NVIDIA H100 80GB HBM3": {
        "tf32_flops_s": 495e12,     # dense TF32 tensor-core rate
        "fp32_flops_s": 67e12,      # CUDA cores
        "bf16_flops_s": 989e12,
        "hbm_bytes_s": 3.35e12,
        "memory_bytes": 80e9,
    },
}
