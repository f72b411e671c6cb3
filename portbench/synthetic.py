"""Synthetic LM token stream, frozen for the benchmark.

Frozen copy of ``SyntheticLM`` from ``src/repro_torch/data/synthetic.py``
at commit 050b402 (itself the JAX package's ``data/synthetic.py``): a
first-order Markov chain with Zipfian next-token probabilities. Kept here
so that no later change to the program can move the benchmark's traffic.
The traffic kinds draw a whole pool of batches with one call of
``sample``.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class SyntheticLM:
    """First-order Markov chain with Zipfian marginals."""
    vocab_size: int = 512
    branching: int = 8
    seed: int = 0

    def __post_init__(self):
        rng = np.random.default_rng(self.seed)
        V = self.vocab_size
        self.next_tokens = rng.integers(0, V, (V, self.branching))
        probs = 1.0 / np.arange(1, self.branching + 1)
        self.next_probs = probs / probs.sum()

    def sample(self, rng: np.random.Generator, batch: int, seq_len: int):
        """(tokens, labels), each [batch, seq_len] int32: labels are the
        tokens shifted by one."""
        toks = np.empty((batch, seq_len + 1), np.int32)
        toks[:, 0] = rng.integers(0, self.vocab_size, batch)
        for t in range(seq_len):
            choice = rng.choice(self.branching, size=batch, p=self.next_probs)
            toks[:, t + 1] = self.next_tokens[toks[:, t], choice]
        return toks[:, :-1], toks[:, 1:]
