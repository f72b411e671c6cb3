"""Pytrees of dicts and lists: the port's stand-in for ``jax.tree``.

Layer parameters are nested dicts of tensors, as in the reference; the
transformer's ``params["blocks"]`` is a list of slot dicts. The flatten
order is ``jax.tree.flatten``'s: dict keys sorted, list items in order,
recursively, so a layer's packed flat buffer
(``kernels/fused_sgd/ops.pack_leaves``) has the same layout in both
packages and flat buffers can be swapped between them. A structure is
recorded as the list of key paths of its leaves; a list index is an int
in the path.
"""
from __future__ import annotations

from typing import Any, Callable


def flatten(tree: Any) -> tuple[list, list[tuple]]:
    """(leaves, key paths), dict keys in sorted order, list items in
    order."""
    leaves, paths = [], []

    def walk(node, path):
        if isinstance(node, dict):
            for k in sorted(node):
                walk(node[k], path + (k,))
        elif isinstance(node, list):
            for i, item in enumerate(node):
                walk(item, path + (i,))
        else:
            leaves.append(node)
            paths.append(path)

    walk(tree, ())
    return leaves, paths


def leaves(tree: Any) -> list:
    return flatten(tree)[0]


def unflatten(paths: list[tuple], values: list) -> Any:
    """Inverse of ``flatten``: nested dicts and lists rebuilt from key
    paths (a node whose keys are ints is a list)."""

    def build(items):
        if items[0][0] == ():
            return items[0][1]
        groups: dict = {}
        for path, v in items:
            groups.setdefault(path[0], []).append((path[1:], v))
        if all(isinstance(k, int) for k in groups):
            return [build(groups[i]) for i in range(len(groups))]
        return {k: build(g) for k, g in groups.items()}

    return build(list(zip(paths, values))) if paths else {}


def map(fn: Callable, tree: Any, *rest: Any) -> Any:  # noqa: A001
    """``fn`` applied leafwise over trees of the same structure."""
    vals, paths = flatten(tree)
    others = [flatten(t)[0] for t in rest]
    return unflatten(paths, [fn(*args) for args in zip(vals, *others)])
