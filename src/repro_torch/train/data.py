"""Deterministic synthetic data (a port of the JAX package's
``train/data.py``).

No corpus: a batch is a pure function of ``(seed, step, shape)``, so a
restarted trainer regenerates exactly the batch it stopped on (a
checkpoint only needs the step counter).

* tokens follow a Zipf unigram draw (token id = rank - 1, probability
  proportional to ``rank ** -zipf_a``), with the BOS token 0 at every
  ``doc_len``-th position;
* the stub frontends' extras (``enc_embeds``, ``vision_embeds``: 0.02 x a
  standard normal) come alongside when the config asks for them.

The draw runs on a CPU ``torch.Generator`` seeded from ``(seed, step)``
and then moves to the device, so the card and the host get the same
tokens.  It cannot reproduce ``jax.random``'s bits (nor can the
parameters' init): to compare with the reference, feed both sides the
same tokens.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterator, Optional

import numpy as np
import torch

from ..device import resolve_device
from ..models.config import ModelConfig

__all__ = ["DataConfig", "SyntheticData", "data_for"]


@dataclass(frozen=True)
class DataConfig:
    batch: int
    seq_len: int
    seed: int = 0
    doc_len: int = 512
    zipf_a: float = 1.2
    n_enc_tokens: int = 0     # >0: audio frames (whisper stub)
    n_vis_tokens: int = 0     # >0: vision patches (internvl stub)


def _step_generator(seed: int, step: int) -> torch.Generator:
    """A CPU generator whose state is a function of ``(seed, step)``
    alone."""
    words = np.random.SeedSequence([seed, step]).generate_state(2, np.uint32)
    return torch.Generator().manual_seed(
        (int(words[0]) << 31) ^ int(words[1]))


class SyntheticData:
    """Stateless deterministic batch source (step -> batch) on
    ``device``."""

    def __init__(self, cfg: DataConfig, model: ModelConfig, device="cuda"):
        self.cfg = cfg
        self.model = model
        self.device = resolve_device(device)
        ranks = np.arange(1, model.vocab + 1, dtype=np.float64)
        p = ranks ** (-cfg.zipf_a)
        self._probs = torch.from_numpy(p / p.sum())

    def batch_for_step(self, step: int) -> Dict[str, torch.Tensor]:
        c, m = self.cfg, self.model
        gen = _step_generator(c.seed, step)
        tokens = torch.multinomial(self._probs, c.batch * c.seq_len,
                                   replacement=True, generator=gen)
        tokens = tokens.reshape(c.batch, c.seq_len)
        tokens[:, torch.arange(c.seq_len) % c.doc_len == 0] = 0   # BOS
        out = {"tokens": tokens}
        if c.n_enc_tokens:
            out["enc_embeds"] = 0.02 * torch.randn(
                (c.batch, c.n_enc_tokens, m.d_model), generator=gen)
        if c.n_vis_tokens:
            out["vision_embeds"] = 0.02 * torch.randn(
                (c.batch, c.n_vis_tokens, m.d_model), generator=gen)
        return {k: v.to(self.device) for k, v in out.items()}

    def __iter__(self) -> Iterator[Dict[str, torch.Tensor]]:
        step = 0
        while True:
            yield self.batch_for_step(step)
            step += 1


def data_for(model: ModelConfig, batch: int, seq_len: int, seed: int = 0,
             n_enc: Optional[int] = None, device="cuda") -> SyntheticData:
    """Data source with the right stub-frontend extras for ``model``.

    ``n_enc``: encoder frames for enc-dec models (default 1500, whisper's
    30-s log-mel frame count after the conv stub; pass a small value for
    reduced configs)."""
    if n_enc is None:
        n_enc = 1500 if model.is_encdec else 0
    n_enc = n_enc if model.is_encdec else 0
    n_vis = model.n_frontend_tokens if model.frontend == "vision" else 0
    n_vis = min(n_vis, max(1, seq_len // 2)) if n_vis else 0
    return SyntheticData(
        DataConfig(batch=batch, seq_len=seq_len, seed=seed,
                   n_enc_tokens=n_enc, n_vis_tokens=n_vis), model,
        device=device)
