"""Slot-based continuous-batching serving engine on the sequential decode
path (per-slot positions — every request at its own offset in its own ring
cache row).

The port of ``repro.serving.engine``, with its scheduling: at each engine
step every ACTIVE slot advances one token — prompt tokens are fed
(prefill-by-decode) until exhausted, then sampled continuations; finished
slots retire (max tokens, EOS, or the cache length reached) and are
refilled from the queue, their cache rows zeroed. The engine runs on
``device`` (CUDA unless told otherwise; it raises without it) and samples
with a ``torch.Generator`` seeded from ``seed`` when ``temperature > 0``.
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import Optional

import numpy as np
import torch

from repro_torch import tree
from repro_torch.configs.base import ModelConfig
from repro_torch.models import model as model_lib
from repro_torch.runtime.devices import resolve_device


@dataclasses.dataclass
class Request:
    uid: int
    prompt: list[int]
    max_new_tokens: int
    generated: list[int] = dataclasses.field(default_factory=list)
    done: bool = False


class ServingEngine:
    """Greedy (or temperature) continuous-batching generation."""

    def __init__(self, cfg: ModelConfig, params, *, max_slots: int = 4,
                 cache_len: int = 64, eos_id: Optional[int] = None,
                 temperature: float = 0.0, seed: int = 0, device=None):
        self.device = resolve_device(device)
        self.cfg = cfg
        self.params = params
        self.max_slots = max_slots
        self.cache_len = cache_len
        self.eos_id = eos_id
        self.temperature = temperature
        self._gen = torch.Generator(device=self.device).manual_seed(seed)
        self._queue: deque[Request] = deque()
        self._slots: list[Optional[Request]] = [None] * max_slots
        self._pos = np.zeros(max_slots, np.int32)      # next position to write
        self._next_tok = np.zeros(max_slots, np.int32)
        self._uid = 0
        self.caches = model_lib.init_caches(cfg, batch=max_slots,
                                            cache_len=cache_len,
                                            dtype=torch.float32,
                                            device=self.device)

    # ------------------------------- api --------------------------------
    def submit(self, prompt: list[int], max_new_tokens: int = 16) -> int:
        self._uid += 1
        self._queue.append(Request(self._uid, list(prompt), max_new_tokens))
        return self._uid

    def run_until_drained(self, max_steps: int = 10_000) -> dict[int, list[int]]:
        out: dict[int, list[int]] = {}
        for _ in range(max_steps):
            finished = self.step()
            for r in finished:
                out[r.uid] = r.generated
            if not self._queue and all(s is None for s in self._slots):
                break
        return out

    # ----------------------------- internals ----------------------------
    def _decode_step(self, params, caches, tokens, pos):
        logits, new_caches = model_lib.sequential_decode_step(
            params, self.cfg, tokens[:, None], caches, pos)
        return logits[:, 0], new_caches

    def _reset_slot_cache(self, i: int):
        """Zero slot i's rows in every cache leaf (fresh request)."""
        for leaf in tree.leaves(self.caches):
            leaf[:, i] = 0

    def step(self) -> list[Request]:
        # admit queued requests into free slots
        for i in range(self.max_slots):
            if self._slots[i] is None and self._queue:
                r = self._queue.popleft()
                self._slots[i] = r
                self._pos[i] = 0
                self._next_tok[i] = r.prompt[0]
                self._reset_slot_cache(i)
        if all(s is None for s in self._slots):
            return []

        tokens = torch.tensor(self._next_tok, device=self.device)
        pos = torch.tensor(self._pos, device=self.device)
        with torch.no_grad():
            logits, self.caches = self._decode_step(self.params, self.caches,
                                                    tokens, pos)
            if self.temperature > 0:
                probs = torch.softmax(logits.float() / self.temperature, -1)
                sampled = torch.multinomial(probs, 1,
                                            generator=self._gen)[:, 0]
            else:
                sampled = torch.argmax(logits, dim=-1)
        sampled = sampled.cpu().numpy()

        finished = []
        for i, r in enumerate(self._slots):
            if r is None:
                continue
            consumed = int(self._pos[i]) + 1       # tokens fed so far
            self._pos[i] += 1
            if consumed < len(r.prompt):
                self._next_tok[i] = r.prompt[consumed]   # still prefilling
                continue
            tok = int(sampled[i])
            r.generated.append(tok)
            self._next_tok[i] = tok
            hit_eos = self.eos_id is not None and tok == self.eos_id
            if (len(r.generated) >= r.max_new_tokens or hit_eos
                    or int(self._pos[i]) >= self.cache_len):
                r.done = True
                finished.append(r)
                self._slots[i] = None
        return finished
