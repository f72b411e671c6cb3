"""The device mesh of the pipeline engine, on one device.

The port of the part of ``repro.launch.mesh`` the engine needs. The JAX
engine runs one SPMD body per device of a (data, stage, tensor) mesh; the
port runs the same schedule on one device (``pipeline/pipeline_step.py``
says how each axis is folded), so a mesh here is only its axis names,
their sizes and the torch device the engine computes on.
``make_production_mesh`` and ``make_train_mesh`` give the JAX package's
pod layouts by name and size, for the cost model and the dry run
(``launch/dryrun.py``, which passes ``device="meta"``).
"""
from __future__ import annotations

import contextlib
import dataclasses

import torch

from repro_torch.runtime.devices import resolve_device

MODEL_AXIS = 16
DATA_AXIS = 16
NUM_PODS = 2


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


def make_production_mesh(*, multi_pod: bool = False,
                         device=None) -> LocalMesh:
    """The deployment's physical mesh: one pod = (data=16, model=16); two
    pods = (pod=2, data=16, model=16)."""
    shape = (NUM_PODS, DATA_AXIS, MODEL_AXIS) if multi_pod \
        else (DATA_AXIS, MODEL_AXIS)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_local_mesh(shape, axes, device)


def make_train_mesh(pipeline_stages: int, tensor_parallel: int, *,
                    extra_data: int = 1, multi_pod: bool = False,
                    device=None) -> LocalMesh:
    """The per-architecture logical view (pod?, data, extra?, stage,
    tensor) of the production mesh: stage x tensor x extra_data tiles the
    16-wide model axis (extra_data becomes more data parallelism). The JAX
    function also asserts that enough devices exist; every axis here is
    folded onto ``device``, so there is no count to check."""
    if pipeline_stages * tensor_parallel * extra_data != MODEL_AXIS:
        raise ValueError(f"stage {pipeline_stages} x tensor "
                         f"{tensor_parallel} x extra {extra_data} != "
                         f"{MODEL_AXIS}")
    shape = (DATA_AXIS, extra_data, pipeline_stages, tensor_parallel)
    names = ("data", "extra", "stage", "tensor")
    if multi_pod:
        shape = (NUM_PODS,) + shape
        names = ("pod",) + names
    if extra_data == 1:
        shape = tuple(s for s, nm in zip(shape, names) if nm != "extra")
        names = tuple(nm for nm in names if nm != "extra")
    return make_local_mesh(shape, names, device)


def make_debug_mesh(data: int = 2, stage: int = 2, tensor: int = 2,
                    device=None) -> LocalMesh:
    """The JAX package's (data, stage, tensor) test mesh, on ``device``."""
    return make_local_mesh((data, stage, tensor), ("data", "stage", "tensor"),
                           device)


def mesh_context(mesh):
    """Does nothing: the port's engine takes its mesh as an argument. Kept
    so that call sites read as the JAX package's do."""
    return contextlib.nullcontext(mesh)
