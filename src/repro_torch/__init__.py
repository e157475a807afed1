"""repro_torch — the PyTorch/CUDA port of the DFRS scheduling reproduction.

It runs two paths of the reference on one device, each with hand-written
Hopper kernels:

* the paper's scheduling path — a Lublin trace through the event-loop
  engine, with the §4.6 OPT=MIN / OPT=AVG reallocations batched onto the
  device and the water-filling in CUDA; its public surface is
  :mod:`repro_torch.api`;
* the model substrate's serving path for RecurrentGemma-2B, RWKV6-7B and
  the dense decoders (Llama-3-8B, Qwen3-8B, SmolLM-360M, Granite-3-2B) —
  :mod:`repro_torch.train.serve` (``BatchedServer``: prefill and
  continuous-batching decode) over :mod:`repro_torch.models`, with flash
  attention, flash decode, the RG-LRU scan and the RWKV6 WKV recurrence in
  CUDA; its command line is ``python -m repro_torch.launch.serve``.

Device entry points run on ``"cuda"`` unless told ``"cpu"``
(:mod:`repro_torch.device`).  The package imports ``torch``, numpy and
scipy only.
"""
from __future__ import annotations

__all__ = ["api"]


def __getattr__(name):
    # lazy: `import repro_torch` stays cheap; `repro_torch.api` loads on
    # first touch
    if name == "api":
        import importlib
        return importlib.import_module(".api", __name__)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
