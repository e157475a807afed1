"""A cell of ``BENCHMARK.json`` cut to a size the CPU tests can hold: the
same configuration, traffic mix and limits with every width, depth and
length made small (the tests' stand-in for the chip's sizes)."""
from __future__ import annotations

from typing import Dict

from . import common

TINY = {
    "smollm-360m.pretrain": (
        dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
             d_ff=128, vocab=256),
        dict(batch=4, seq_len=32, doc_len=16)),
    "whisper-large-v3.finetune": (
        dict(n_layers=2, encoder_layers=2, d_model=64, n_heads=4,
             n_kv_heads=4, head_dim=16, d_ff=128, vocab=256),
        dict(batch=4, seq_len=16, enc_frames=24, doc_len=16)),
}


def tiny_cell(name: str) -> Dict:
    c = common.cell(name)
    model, traffic = TINY[name]
    c["config"]["model"].update(model)
    c["traffic"].update(traffic)
    return c
