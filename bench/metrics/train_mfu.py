"""Model FLOPs of the window's steps (``work``, without remat's
recompute) over the window's time and the chip's dense TF32 peak, in %.
The step is fp32: single-pass TF32 bounds every method that keeps fp32's
results, so an honest fp32 step cannot read over 100 %."""


def read(rec):
    peak = rec["peaks"].get("tf32_flops_s")
    if not peak or not rec["steps"]:
        return None
    return 100.0 * rec["steps"] * rec["train_flops"] / rec["window_s"] / peak
