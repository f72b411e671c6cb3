"""The device mesh of the pipeline engine: folded onto one device, or one
process a mesh position.

The port of the part of ``repro.launch.mesh`` the engine needs. The JAX
engine runs one SPMD body per device of a (data, stage, tensor) mesh.
The port has two meshes:
- ``LocalMesh``: the mesh's axis names and sizes and the one torch device
  the engine runs the whole schedule on (``pipeline/pipeline_step.py``
  says how each axis is folded);
- ``RankMesh``: this process is one position of the mesh, one rank of
  the ``torch.distributed`` world (ranks laid out row-major over the axes,
  as ``jax.make_mesh`` lays out devices), with a process group for each
  axis and for the combinations the engine reduces over.
``make_debug_mesh`` and ``make_train_mesh`` build a ``RankMesh`` when a
process group is up (``torchrun``, ``pipeline/ranks.py``) and a
``LocalMesh`` otherwise. ``make_production_mesh`` and ``make_train_mesh``
give the JAX package's pod layouts by name and size, for the cost model
and the dry run (``launch/dryrun.py``, which passes ``device="meta"``).
"""
from __future__ import annotations

import contextlib
import dataclasses
import datetime
import itertools
import math
import os
from typing import Any

import torch
import torch.distributed as dist

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


# the axis combinations a RankMesh makes groups for: each axis alone, the
# data axes together (the batch split, the loss's mean, the gradient sum)
# and stage x tensor (the vocab-parallel embedding and head)
DATA_AXES = ("pod", "data", "extra")
VOCAB_AXES = ("stage", "tensor")


@dataclasses.dataclass(frozen=True, eq=False)
class RankMesh:
    """One rank's position in a logical mesh whose positions are the ranks
    of the ``torch.distributed`` world. ``coords`` is this rank's
    coordinate on each axis; ``groups`` maps a tuple of axes to the process
    group of the ranks that share this rank's other coordinates (absent for
    a combination of size 1). Build it with ``make_rank_mesh``."""
    axis_names: tuple[str, ...]
    axis_sizes: tuple[int, ...]
    device: torch.device
    rank: int
    coords: dict[str, int]
    groups: dict[tuple[str, ...], Any]
    backend: str

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(self.axis_names, self.axis_sizes))

    def axes(self, names) -> tuple[str, ...]:
        """``names`` that are axes of this mesh, in mesh order."""
        return tuple(a for a in self.axis_names if a in names)

    def group(self, names):
        """The process group over the axes ``names`` of this mesh (None
        where they span one rank)."""
        axes = self.axes(names)
        if axes not in self.groups and self.size(axes) > 1:
            raise KeyError(f"no process group over {axes}")
        return self.groups.get(axes)

    def size(self, names) -> int:
        return math.prod(self.shape[a] for a in self.axes(names))

    def index(self, names) -> int:
        """This rank's row-major coordinate over the axes ``names`` (the
        JAX package's ``axis_index`` of a tuple of axes)."""
        return _row_major(self.axes(names), self.shape, self.coords)

    def rank_at(self, **coords) -> int:
        """The global rank at this rank's coordinates with ``coords``
        changed."""
        return _row_major(self.axis_names, self.shape,
                          {**self.coords, **coords})


def ranked(mesh) -> bool:
    """Whether ``mesh`` is one rank's position (a ``RankMesh``) rather
    than a mesh folded onto one device."""
    return isinstance(mesh, RankMesh)


def _row_major(axes, shape: dict, coords: dict) -> int:
    i = 0
    for a in axes:
        i = i * shape[a] + coords[a]
    return i


def rank_coords(axis_names, axis_sizes, rank: int) -> dict[str, int]:
    """The coordinates of global ``rank`` in the row-major layout."""
    out = {}
    for a, n in zip(reversed(axis_names), reversed(axis_sizes)):
        rank, out[a] = divmod(rank, n)
    return {a: out[a] for a in axis_names}


def make_rank_mesh(axis_sizes, axis_names, device=None) -> RankMesh:
    """This process's ``RankMesh`` in the initialised default process
    group, whose size must equal the mesh's. Every rank must call it at
    the same point (``dist.new_group`` is collective): the groups are made
    in one order on every rank, for every axis combination the engine
    uses. ``device`` defaults to CUDA (raises without it)."""
    names = tuple(axis_names)
    sizes = tuple(int(n) for n in axis_sizes)
    world, rank = dist.get_world_size(), dist.get_rank()
    if world != math.prod(sizes):
        raise ValueError(f"the world has {world} ranks, the mesh "
                         f"{dict(zip(names, sizes))} {math.prod(sizes)}")
    coords = rank_coords(names, sizes, rank)
    combos = [(a,) for a in names]
    for combo in (DATA_AXES, VOCAB_AXES):
        c = tuple(a for a in names if a in combo)
        if len(c) > 1:
            combos.append(c)
    shape = dict(zip(names, sizes))
    everyone = [rank_coords(names, sizes, r) for r in range(world)]
    groups = {}
    for combo in combos:
        if math.prod(shape[a] for a in combo) == 1:
            continue
        rest = [a for a in names if a not in combo]
        for fixed in itertools.product(*(range(shape[a]) for a in rest)):
            members = [r for r, c in enumerate(everyone)
                       if all(c[a] == v for a, v in zip(rest, fixed))]
            g = dist.new_group(members)
            if rank in members:
                groups[combo] = g
    return RankMesh(names, sizes, resolve_device(device), rank, coords,
                    groups, dist.get_backend())


def init_ranks_from_env(device=None, timeout_s: float = 900.0):
    """Under ``torchrun`` (``WORLD_SIZE``, ``RANK`` and ``LOCAL_RANK`` in
    the environment): start the default process group, NCCL on CUDA and
    gloo on the CPU, with a bounded timeout, and return this rank's device
    (CUDA device ``LOCAL_RANK``). Returns None, and starts nothing, when
    the process was not launched so."""
    if not all(k in os.environ for k in ("WORLD_SIZE", "RANK",
                                          "LOCAL_RANK")):
        return None
    dev = resolve_device(device)
    if dev.type == "cuda":
        dev = torch.device("cuda", int(os.environ["LOCAL_RANK"]))
        torch.cuda.set_device(dev)
    if not dist.is_initialized():
        dist.init_process_group(
            "nccl" if dev.type == "cuda" else "gloo",
            timeout=datetime.timedelta(seconds=timeout_s))
    return dev


def make_local_mesh(axis_sizes, axis_names, device=None) -> LocalMesh:
    """A ``LocalMesh`` on ``device`` (CUDA unless the caller names
    another; raises without it)."""
    return LocalMesh(tuple(axis_names), tuple(int(n) for n in axis_sizes),
                     resolve_device(device))


def _make_mesh(axis_sizes, axis_names, device):
    """A ``RankMesh`` when a process group is up, else a ``LocalMesh``."""
    if dist.is_available() and dist.is_initialized():
        return make_rank_mesh(axis_sizes, axis_names, device)
    return make_local_mesh(axis_sizes, axis_names, device)


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
                    device=None):
    """The per-architecture logical view (pod?, data, extra?, stage,
    tensor) of the production mesh: stage x tensor x extra_data tiles the
    16-wide model axis (extra_data becomes more data parallelism). The JAX
    function asserts that enough devices exist; folded onto ``device``
    there is no count to check, and on ranks the world must be the mesh's
    size (``make_rank_mesh``)."""
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
    return _make_mesh(shape, names, device)


def make_debug_mesh(data: int = 2, stage: int = 2, tensor: int = 2,
                    device=None):
    """The JAX package's (data, stage, tensor) test mesh, on ``device``:
    one rank a position when a process group is up, else folded."""
    return _make_mesh((data, stage, tensor), ("data", "stage", "tensor"),
                      device)


def mesh_context(mesh):
    """Does nothing: the port's engine takes its mesh as an argument. Kept
    so that call sites read as the JAX package's do."""
    return contextlib.nullcontext(mesh)
