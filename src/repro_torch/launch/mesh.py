"""The device mesh of the pipeline engine, on one device.

The port of the part of ``repro.launch.mesh`` the engine needs. The JAX
engine runs one SPMD body per device of a (data, stage, tensor) mesh; the
port runs the same schedule on one device (``pipeline/pipeline_step.py``
says how each axis is folded), so a mesh here is only its axis names,
their sizes and the torch device the engine computes on.
``make_production_mesh`` and ``make_train_mesh`` (the TPU pod layouts)
are ROADMAP Queue 1 item 13.
"""
from __future__ import annotations

import contextlib
import dataclasses

import torch

from repro_torch.runtime.devices import resolve_device


@dataclasses.dataclass(frozen=True)
class LocalMesh:
    """Axis names and sizes of a logical mesh, folded onto ``device``."""
    axis_names: tuple[str, ...]
    axis_sizes: tuple[int, ...]
    device: torch.device

    def __post_init__(self):
        if len(self.axis_names) != len(self.axis_sizes):
            raise ValueError(f"{self.axis_names} vs {self.axis_sizes}")
        if any(n < 1 for n in self.axis_sizes):
            raise ValueError(f"axis sizes must be >= 1: {self.axis_sizes}")

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(self.axis_names, self.axis_sizes))


def make_local_mesh(axis_sizes, axis_names, device=None) -> LocalMesh:
    """A ``LocalMesh`` on ``device`` (CUDA unless the caller names
    another; raises without it)."""
    return LocalMesh(tuple(axis_names), tuple(int(n) for n in axis_sizes),
                     resolve_device(device))


def make_debug_mesh(data: int = 2, stage: int = 2, tensor: int = 2,
                    device=None) -> LocalMesh:
    """The JAX package's (data, stage, tensor) test mesh, on ``device``."""
    return make_local_mesh((data, stage, tensor), ("data", "stage", "tensor"),
                           device)


def mesh_context(mesh):
    """Does nothing: the port's engine takes its mesh as an argument. Kept
    so that call sites read as the JAX package's do."""
    return contextlib.nullcontext(mesh)
