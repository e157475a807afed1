"""Batched serving loop: prefill + decode with a continuous-batching
queue (a port of the JAX package's ``train/serve.py``).

Requests arrive with prompts and are packed into a fixed number of decode
slots; finished slots are refilled from the queue.  Greedy or temperature
sampling.  Where the reference jit-compiles one decode program of fixed
shape, the port runs the same fixed-shape step eagerly, with the attention,
RG-LRU and WKV kernels on the card.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np
import torch

from ..device import resolve_device
from ..models import backbone
from ..models.config import ModelConfig

__all__ = ["Request", "ServeConfig", "BatchedServer"]


@dataclass
class Request:
    rid: int
    prompt: np.ndarray                 # (prompt_len,) int32
    max_new: int = 32
    out: List[int] = field(default_factory=list)
    done: bool = False


@dataclass(frozen=True)
class ServeConfig:
    slots: int = 4                     # decode batch
    cache_len: int = 256
    temperature: float = 0.0           # 0 -> greedy
    eos_id: int = -1                   # -1 -> never stop on token
    seed: int = 0


class BatchedServer:
    """Continuous batching over a fixed slot count.

    Prefill runs per request into its slot's cache, and the first token is
    sampled from the prefill logits; decode is one fixed-shape step over
    all slots with per-slot positions.  Slot admission is FCFS, as in the
    reference.  ``device`` is "cuda" unless the caller asks for "cpu"; it
    raises when CUDA is asked for and missing.
    """

    def __init__(self, cfg: ModelConfig, params, scfg: ServeConfig,
                 device="cuda"):
        self.device = resolve_device(device)
        self.cfg = cfg
        self.params = params
        self.scfg = scfg
        self.caches = backbone.init_cache(cfg, scfg.slots, scfg.cache_len,
                                          device=self.device)
        self.pos = np.zeros(scfg.slots, dtype=np.int32)       # next position
        self.slot_req: List[Optional[Request]] = [None] * scfg.slots
        self.queue: List[Request] = []
        self.last_tok = np.zeros(scfg.slots, dtype=np.int32)
        self._gen = torch.Generator(device=self.device)
        self._gen.manual_seed(scfg.seed)

    # ---- the model calls ---------------------------------------------------
    def _prefill_impl(self, tokens, caches_slot, true_len: int):
        """Prefill one request into a single-slot cache.  As the
        reference's, an encoder-decoder encodes 8 zero frames, whose cross
        K/V its empty cross cache (``S_enc = 0``) does not keep, so decode
        attends to no frame; a vision config raises ``KeyError``
        (``vision_embeds``): the server has no frontend input."""
        batch = {"tokens": tokens[None, :]}
        if self.cfg.is_encdec:
            batch["enc_embeds"] = torch.zeros((1, 8, self.cfg.d_model),
                                              device=self.device)
        logits, caches = backbone.prefill(self.cfg, self.params, batch,
                                          caches_slot)
        return logits[0], caches

    def _decode_impl(self, tokens, caches, pos):
        return backbone.decode_step(self.cfg, self.params, tokens, caches, pos)

    # ---- queue management --------------------------------------------------
    def submit(self, req: Request) -> None:
        self.queue.append(req)

    def _free_slots(self) -> List[int]:
        return [i for i, r in enumerate(self.slot_req) if r is None]

    def _admit(self) -> None:
        for slot in self._free_slots():
            if not self.queue:
                return
            req = self.queue.pop(0)
            L = len(req.prompt)
            if L >= self.scfg.cache_len:
                raise ValueError(f"prompt of {L} tokens does not fit a cache "
                                 f"of {self.scfg.cache_len}")
            # The reference slices the slot's cache out, prefills it and
            # sets it back; here the slot's views are written in place.
            # As there, the slot's previous contents are not cleared first.
            slot_cache = backbone.slot_view(self.caches, slot)
            tokens = torch.as_tensor(np.asarray(req.prompt, np.int64),
                                     device=self.device)
            logits, _ = self._prefill_impl(tokens, slot_cache, L)
            tok = self._sample(logits)
            req.out.append(tok)                 # first generated token
            if len(req.out) >= req.max_new or tok == self.scfg.eos_id:
                req.done = True
                continue
            self.slot_req[slot] = req
            self.pos[slot] = L
            self.last_tok[slot] = tok

    def _sample(self, logits) -> int:
        if self.scfg.temperature <= 0.0:
            return int(torch.argmax(logits))
        probs = torch.softmax(logits.float() / self.scfg.temperature, dim=-1)
        return int(torch.multinomial(probs, 1, generator=self._gen))

    # ---- main loop ---------------------------------------------------------
    def step(self) -> int:
        """One decode step over all occupied slots.  Returns #active slots."""
        self._admit()
        active = [i for i, r in enumerate(self.slot_req) if r is not None]
        if not active:
            return 0
        tokens = torch.as_tensor(self.last_tok.astype(np.int64),
                                 device=self.device)
        pos = torch.as_tensor(self.pos.astype(np.int64), device=self.device)
        logits, self.caches = self._decode_impl(tokens, self.caches, pos)
        if self.scfg.temperature <= 0.0:        # one read for every slot
            picks = torch.argmax(logits, dim=-1).tolist()
        else:
            picks = [self._sample(logits[i]) if i in active else 0
                     for i in range(len(self.slot_req))]
        for i in active:
            req = self.slot_req[i]
            tok = int(picks[i])
            req.out.append(tok)
            self.last_tok[i] = tok
            self.pos[i] += 1
            if (len(req.out) >= req.max_new
                    or tok == self.scfg.eos_id
                    or self.pos[i] >= self.scfg.cache_len):
                req.done = True
                self.slot_req[i] = None
        return len(active)

    def run_until_drained(self, max_steps: int = 10_000) -> int:
        """Step until the queue and the slots are empty; returns the steps
        taken.  (The reference returns an always-empty list here.)"""
        for steps in range(max_steps):
            if not self.queue and all(r is None for r in self.slot_req):
                return steps
            self.step()
        return max_steps
