"""Synthetic datasets: a learnable classification task (stands in for
MNIST/CIFAR in the paper's experiments — class-conditional Gaussian images)
and a learnable LM stream (Zipfian bigram chain). Deterministic per seed,
sharded iteration for the data-parallel axis.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class SyntheticClassification:
    """Class-conditional images: class k -> fixed random template + noise.
    Learnable by any conv/MLP net; accuracy is a meaningful metric."""
    num_classes: int = 10
    image_hw: int = 32
    channels: int = 3
    noise: float = 0.6
    seed: int = 0

    def __post_init__(self):
        rng = np.random.default_rng(self.seed)
        self.templates = rng.normal(
            0, 1, (self.num_classes, self.image_hw, self.image_hw,
                   self.channels)).astype(np.float32)

    def sample(self, rng: np.random.Generator, batch: int):
        labels = rng.integers(0, self.num_classes, batch)
        x = self.templates[labels] + rng.normal(
            0, self.noise, (batch, self.image_hw, self.image_hw,
                            self.channels)).astype(np.float32)
        return x.astype(np.float32), labels.astype(np.int32)


def class_batches(ds: SyntheticClassification, batch: int, num_batches: int,
                  seed: int = 0, shard: tuple[int, int] = (0, 1)):
    """Yield (x, y) batches; shard=(index, count) splits the stream."""
    rng = np.random.default_rng(seed + 7919 * shard[0])
    for _ in range(num_batches):
        yield ds.sample(rng, batch // shard[1])


@dataclasses.dataclass
class SyntheticLM:
    """First-order Markov chain with Zipfian marginals — has real structure
    (per-token optimal loss = conditional entropy), so LM training curves
    are meaningful."""
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
        toks = np.empty((batch, seq_len + 1), np.int32)
        toks[:, 0] = rng.integers(0, self.vocab_size, batch)
        for t in range(seq_len):
            choice = rng.choice(self.branching, size=batch, p=self.next_probs)
            toks[:, t + 1] = self.next_tokens[toks[:, t], choice]
        return toks[:, :-1], toks[:, 1:]


def lm_batches(ds: SyntheticLM, batch: int, seq_len: int, num_batches: int,
               seed: int = 0, shard: tuple[int, int] = (0, 1)):
    rng = np.random.default_rng(seed + 104729 * shard[0])
    for _ in range(num_batches):
        yield ds.sample(rng, batch // shard[1], seq_len)
