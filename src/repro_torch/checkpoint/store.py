"""Pytree checkpointing to disk (a JSON manifest + raw leaf buffers).

The port of ``repro.checkpoint.store``: the central node's own fault
protection (paper §III-E: "saving the training states and model weights
to the disk periodically").

Leaves are written in ``jax.tree.flatten`` order (``repro_torch.tree``
follows it: dict keys sorted, list items in order), each as its raw
C-order bytes, so the ``.bin`` file is the JAX package's byte for byte
and a checkpoint written by either package restores in the other. The
manifest's ``treedef`` is the port's list of leaf key paths (JAX writes
its own treedef string there); restoring reads only the leaf shapes and
dtypes and checks the leaf count and shapes, as the JAX package does.
Tensors go to the host before they are written.
"""
from __future__ import annotations

import json
import os
from typing import Any

import numpy as np
import torch

from repro_torch import tree

# the dtypes numpy has no name for: stored under the JAX package's names
# (ml_dtypes), converted through an integer view of the same width
_VIEWS = {torch.bfloat16: ("bfloat16", torch.int16)}
_BY_NAME = {name: (dt, view) for dt, (name, view) in _VIEWS.items()}


def _host_bytes(leaf) -> tuple[list[int], str, bytes]:
    """(shape, dtype name, raw C-order bytes) of a tensor or array."""
    if torch.is_tensor(leaf):
        t = leaf.detach().to("cpu").contiguous()
        if t.dtype in _VIEWS:
            name, view = _VIEWS[t.dtype]
            return list(t.shape), name, t.view(view).numpy().tobytes()
        a = t.numpy()
    else:
        a = np.ascontiguousarray(np.asarray(leaf))
    return list(a.shape), str(a.dtype), a.tobytes()


def _from_bytes(buf: bytes, spec: dict, like):
    """A leaf of the stored dtype and shape, as a tensor on ``like``'s
    device (on the CPU where ``like`` is not a tensor)."""
    shape = spec["shape"]
    if spec["dtype"] in _BY_NAME:
        dt, view = _BY_NAME[spec["dtype"]]
        t = torch.frombuffer(bytearray(buf), dtype=view).view(dt)
    else:
        t = torch.from_numpy(np.frombuffer(buf, dtype=spec["dtype"]).copy())
    t = t.reshape(shape)
    return t.to(like.device) if torch.is_tensor(like) else t


def _itemsize(name: str) -> int:
    if name in _BY_NAME:
        return _BY_NAME[name][0].itemsize
    return np.dtype(name).itemsize


def save_pytree(path: str, tree_: Any, meta: dict | None = None) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    leaves, paths = tree.flatten(tree_)
    host = [_host_bytes(l) for l in leaves]
    manifest = {"treedef": str(paths), "meta": meta or {},
                "leaves": [{"shape": shape, "dtype": dtype}
                           for shape, dtype, _ in host]}
    with open(path + ".json", "w") as f:
        json.dump(manifest, f)
    with open(path + ".bin", "wb") as f:
        for _, _, buf in host:
            f.write(buf)


def restore_pytree(path: str, like: Any) -> Any:
    """Restore into the structure of ``like`` (shapes must match)."""
    leaves, paths = tree.flatten(like)
    with open(path + ".json") as f:
        manifest = json.load(f)
    if len(manifest["leaves"]) != len(leaves):
        raise ValueError(f"structure mismatch: {len(manifest['leaves'])} "
                         f"leaves stored, {len(leaves)} expected")
    out = []
    with open(path + ".bin", "rb") as f:
        for l, spec in zip(leaves, manifest["leaves"]):
            if list(np.shape(l)) != spec["shape"]:
                raise ValueError(f"shape mismatch: stored {spec}, expected "
                                 f"{list(np.shape(l))}")
            n = int(np.prod(spec["shape"])) * _itemsize(spec["dtype"])
            out.append(_from_bytes(f.read(n), spec, l))
    return tree.unflatten(paths, out)


class CheckpointStore:
    """Step-indexed checkpoint directory with retention."""

    def __init__(self, directory: str, keep: int = 3):
        self.directory = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)

    def _path(self, step: int) -> str:
        return os.path.join(self.directory, f"ckpt_{step:08d}")

    def save(self, step: int, tree_: Any, meta: dict | None = None) -> str:
        p = self._path(step)
        save_pytree(p, tree_, {"step": step, **(meta or {})})
        self._gc()
        return p

    def steps(self) -> list[int]:
        out = []
        for fn in os.listdir(self.directory):
            if fn.startswith("ckpt_") and fn.endswith(".json"):
                out.append(int(fn[5:13]))
        return sorted(out)

    def restore_latest(self, like: Any):
        steps = self.steps()
        if not steps:
            return None, -1
        return restore_pytree(self._path(steps[-1]), like), steps[-1]

    def _gc(self):
        steps = self.steps()
        for s in steps[:-self.keep]:
            for ext in (".json", ".bin"):
                try:
                    os.remove(self._path(s) + ext)
                except FileNotFoundError:
                    pass
