"""The general generator of training traffic: every batch a pure function
of (``--seed``, step), made on the device.

A frozen copy of ``repro_torch.train.data.SyntheticData``'s draw, moved
onto the device: token ids follow a Zipf unigram law (id = rank - 1,
probability proportional to ``rank ** -zipf_a``), with the BOS token 0 at
every ``doc_len``-th position; an encoder-decoder's stub frontend gets
``frame_scale`` times a standard normal, ``enc_frames`` frames of
``d_model``.  The same seed and step give the same batch on the same
device, so the plain reference rebuilds any step the program ran.

Tokens are drawn by the inverse of the law's distribution function,
which the host sums once in float64: a float64 uniform from the device's
generator, then ``searchsorted``.  (``torch.multinomial`` on the card
sums the probabilities anew on every call, in an order that varies
between runs, so a draw near a boundary can land on the next token: the
same seed then gives two batches.)
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch


def seed_word(seed: int, *stream: int) -> int:
    """A 63-bit generator seed from ``seed`` (any integer) and a stream."""
    words = np.random.SeedSequence(
        [int(seed) % 2**64, *stream]).generate_state(2, np.uint64)
    return int(words[0] ^ (words[1] << np.uint64(1))) & (2**63 - 1)


#: the streams of one seed: weights, and the batch of step i at 1 + i
WEIGHTS_STREAM = 0


class TrainTraffic:
    """Batches of one training mix for one model on ``device``."""

    def __init__(self, traffic: Dict, model: Dict, device):
        self.t, self.m = traffic, model
        self.device = torch.device(device)
        ranks = np.arange(1, model["vocab"] + 1, dtype=np.float64)
        cdf = np.cumsum(ranks ** (-traffic["zipf_a"]))
        self.cdf = torch.from_numpy(cdf / cdf[-1]).to(self.device)

    def positions(self) -> int:
        """Input positions trained a step: tokens, and encoder frames."""
        t = self.t
        return t["batch"] * (t["seq_len"] + t.get("enc_frames", 0))

    def batch(self, seed: int, step: int) -> Dict[str, torch.Tensor]:
        t = self.t
        gen = torch.Generator(device=self.device)
        gen.manual_seed(seed_word(seed, 1 + step))
        B, T = t["batch"], t["seq_len"]
        u = torch.rand(B * T, dtype=torch.float64, generator=gen,
                       device=self.device)
        tokens = torch.searchsorted(self.cdf, u, right=True).clamp_(
            max=self.m["vocab"] - 1).reshape(B, T)
        tokens[:, ::t["doc_len"]] = 0                        # BOS
        out = {"tokens": tokens}
        if t.get("enc_frames"):
            out["enc_embeds"] = t["frame_scale"] * torch.randn(
                (B, t["enc_frames"], self.m["d_model"]), generator=gen,
                device=self.device)
        return out
