"""Tensor-parallel context threaded through block apply functions.

The port of ``repro.models.tp``. Blocks never hard-code mesh axis names;
they receive a ``TP`` describing the tensor axis they run under.
``TP.none()`` (the one-device engine, unit tests, the sequential models)
makes every collective the identity and the shard's offset 0: the folded
engine runs blocks on whole weights, which computes the sum the JAX
engine's ``psum`` forms over shards.

On ranks (``pipeline/pipeline_step.py`` with a ``launch/mesh.RankMesh``)
the axis is real: ``TP.of(mesh)`` carries the process group of the
mesh's tensor axis and the rank's coordinate on it, blocks run on the
rank's weight shards, and ``psum`` / ``all_gather`` are the collectives
of ``repro_torch.collectives``. Their backward is the adjoint of the
forward over all ranks (a ``psum`` of the cotangents, as JAX transposes
``psum`` inside ``shard_map``), not the identity Megatron gives a
reduction: the engine seeds each rank's backward with 1 / (number of
ranks) and sums the gradient of a leaf the ranks replicate, as
``shard_map``'s transpose does (``collectives.py`` says why;
``tests/test_torch_ranks.py`` holds the gradients to the JAX engine's).
"""
from __future__ import annotations

import dataclasses
from typing import Any

from repro_torch import collectives


@dataclasses.dataclass(frozen=True)
class TP:
    axis: str | None = None   # mesh axis name, or None
    size: int = 1             # number of tensor shards
    group: Any = None         # the axis's process group (a RankMesh's)
    rank: int = 0             # this rank's coordinate on the axis

    @staticmethod
    def none() -> "TP":
        return TP(None, 1)

    @staticmethod
    def of(mesh, axis: str = "tensor") -> "TP":
        """The tensor axis of ``mesh``: its process group and this rank's
        coordinate on a ``RankMesh``; ``TP.none()`` on a folded mesh."""
        if getattr(mesh, "rank", None) is None:
            return TP.none()
        return TP(axis, mesh.shape.get(axis, 1), mesh.group((axis,)),
                  mesh.coords.get(axis, 0))

    def _check(self):
        if self.size > 1 and self.group is None:
            raise ValueError(f"TP({self.axis!r}, {self.size}) has no "
                             f"process group: build it with TP.of(mesh) "
                             f"on a launch.mesh.RankMesh")

    def index(self) -> int:
        return 0 if self.axis is None else self.rank

    def psum(self, x):
        if self.axis is None:
            return x
        self._check()
        return collectives.psum(x, self.group)

    def all_gather(self, x, axis: int = -1):
        if self.axis is None:
            return x
        self._check()
        return collectives.all_gather(x, self.group, axis)
