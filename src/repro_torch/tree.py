"""Dict pytrees: the port's stand-in for ``jax.tree``.

Layer parameters are nested dicts of tensors, as in the reference. The
flatten order is ``jax.tree.flatten``'s: dict keys sorted, recursively, so
a layer's packed flat buffer (``kernels/fused_sgd/ops.pack_leaves``) has
the same layout in both packages and flat buffers can be swapped between
them. A structure is recorded as the list of key paths of its leaves.
"""
from __future__ import annotations

from typing import Any, Callable


def flatten(tree: Any) -> tuple[list, list[tuple]]:
    """(leaves, key paths), dict keys in sorted order."""
    leaves, paths = [], []

    def walk(node, path):
        if isinstance(node, dict):
            for k in sorted(node):
                walk(node[k], path + (k,))
        else:
            leaves.append(node)
            paths.append(path)

    walk(tree, ())
    return leaves, paths


def leaves(tree: Any) -> list:
    return flatten(tree)[0]


def unflatten(paths: list[tuple], values: list) -> Any:
    """Inverse of ``flatten``: nested dicts rebuilt from key paths."""
    if len(paths) == 1 and paths[0] == ():
        return values[0]
    out: dict = {}
    for path, v in zip(paths, values):
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = v
    return out


def map(fn: Callable, tree: Any, *rest: Any) -> Any:  # noqa: A001
    """``fn`` applied leafwise over trees of the same structure."""
    vals, paths = flatten(tree)
    others = [flatten(t)[0] for t in rest]
    return unflatten(paths, [fn(*args) for args in zip(vals, *others)])
