"""Weight stashing + the paper's weight aggregation (§III-C).

``VersionedWeights`` is a ring of weight versions, pytree-agnostic (dicts
and lists of tensors, ``repro_torch.tree``). The async-semantics oracle
(``runtime/semantics.py``) keeps one of depth n + 1.

Aggregation: average the live versions ("n-i independent concurrent
trainings") and collapse the ring onto the mean — the paper's Fig. 2
version-jump (ver 3 -> 4 after aggregating) corresponds to ``aggregate()``.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch import tree


def _mean_leaf(*xs):
    xs = [torch.as_tensor(x) for x in xs]
    return (sum(x.to(torch.float32) for x in xs).to(xs[0].dtype)
            / len(xs))


def tree_mean(trees: list[Any]):
    """Leafwise mean of same-structure trees: summed in f32, cast back to
    the first tree's dtype, then divided (the reference's order)."""
    return tree.map(_mean_leaf, *trees)


@dataclasses.dataclass
class VersionedWeights:
    depth: int
    versions: dict[int, Any] = dataclasses.field(default_factory=dict)
    head: int = 0                       # newest version number

    def put(self, version: int, params: Any) -> None:
        self.versions[version] = params
        self.head = max(self.head, version)
        self._prune()

    def get(self, version: int) -> Any:
        """Fetch the stashed version; falls back to the nearest available
        older version (PipeDream semantics: never use a *newer* one)."""
        if version in self.versions:
            return self.versions[version]
        older = [v for v in self.versions if v <= version]
        if older:
            return self.versions[max(older)]
        return self.versions[min(self.versions)]

    def newest(self) -> Any:
        return self.versions[self.head]

    def live_versions(self) -> list[int]:
        return sorted(self.versions)

    def aggregate(self) -> Any:
        """Average all live versions and collapse the ring (paper §III-C)."""
        mean = tree_mean([self.versions[v] for v in sorted(self.versions)])
        self.head += 1                   # aggregation bumps the version
        self.versions = {self.head: mean}
        return mean

    def _prune(self) -> None:
        while len(self.versions) > self.depth:
            del self.versions[min(self.versions)]
