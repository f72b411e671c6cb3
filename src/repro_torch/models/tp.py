"""Tensor-parallel context threaded through block apply functions.

The port of ``repro.models.tp``. The JAX package runs blocks inside
``shard_map`` over a tensor axis; one card has no such axis, so the port
has ``TP.none()`` only: every collective is the identity and the shard's
offset is 0. A ``TP`` with an axis raises until the pipeline engine is
ported (ROADMAP Queue 1 item 12).
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class TP:
    axis: str | None = None   # mesh axis name inside shard_map, or None
    size: int = 1             # number of tensor shards

    def __post_init__(self):
        if self.axis is not None or self.size != 1:
            raise NotImplementedError(
                "tensor parallelism needs the pipeline engine, not ported "
                "yet (ROADMAP Queue 1 item 12): use TP.none()")

    @staticmethod
    def none() -> "TP":
        return TP(None, 1)

    def index(self):
        return 0

    def psum(self, x):
        return x

    def all_gather(self, x, axis: int = -1):
        return x
