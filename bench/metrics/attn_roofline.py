"""The least time the window's forward attention needs (each call the
larger of its FLOPs over the dense TF32 peak and its bytes over HBM's),
over the device time of the attention kernels in the trace, in %.  Remat
runs the forward twice a step; the work counted is the step's one pass,
so a recompute shows as time without work."""

import re

#: the port's prefill attention instances by the names the profiler gives
#: them (``void attn_tf32x3_kernel<32, 64, 128>(...)``), not its decode
#: kernels
KERNELS = re.compile(r"\b(attn_kernel|attn_wgmma_kernel|attn_tf32x3_kernel)\b")


def _is_attention(name: str) -> bool:
    return KERNELS.search(name) is not None


def read(rec):
    peaks = rec["peaks"]
    if not peaks.get("tf32_flops_s") or not rec["steps"]:
        return None
    spent = sum(s for n, s in rec["device"]["by_name"].items()
                if _is_attention(n))
    if not spent:
        return None
    least = sum(c["count"] * max(c["flops"] / peaks["tf32_flops_s"],
                                 c["bytes"] / peaks["hbm_bytes_s"])
                for c in rec["attention_calls"])
    return 100.0 * rec["steps"] * least / spent
