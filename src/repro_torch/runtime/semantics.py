"""Convergence-semantics executor for FTPipeHD's async pipeline.

Collapses the async 1F1B + weight stashing + vertical sync semantics into a
sequential loop that computes REAL gradients (paper §III-C):

  * vertical sync means batch b uses one weight version v(b) at every stage,
    so each training step is: grad at stash[v(b)], applied to the newest
    weights (stale-gradient SGD with staleness n-1);
  * the version timeline is driven by stage 0's 1F1B op order;
  * weight aggregation (the paper's contribution): every `aggregate_every`
    backwards, stage i's weights become the mean of its last (n - i) live
    versions ("n - i independent concurrent trainings"), and the version
    counter bumps — the Fig. 2 ver-3 -> ver-4 jump.

Used by the Fig. 4 (aggregation on/off) and Fig. 8 (continuous learning)
reproductions, where wall-clock is irrelevant but weight-version math is
everything. Gradients come from autograd on detached copies of the stashed
version, so no stashed tensor is ever written or given a grad.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

import numpy as np
import torch

from repro_torch import tree
from repro_torch.core import schedule as sched
from repro_torch.core.stash import VersionedWeights, tree_mean


def value_and_grad(loss_fn: Callable[[Any, Any], torch.Tensor], params,
                   batch) -> tuple[torch.Tensor, Any]:
    """(loss, grads) of ``loss_fn(params, batch)`` w.r.t. every leaf of
    ``params``; grads share the params' tree structure. A leaf the loss
    does not reach gets a zero gradient."""
    leaves, paths = tree.flatten(params)
    with torch.enable_grad():
        req = [leaf.detach().requires_grad_(True) for leaf in leaves]
        loss = loss_fn(tree.unflatten(paths, req), batch)
        grads = torch.autograd.grad(loss, req, allow_unused=True)
    grads = [torch.zeros_like(r) if g is None else g
             for r, g in zip(req, grads)]
    return loss.detach(), tree.unflatten(paths, grads)


@dataclasses.dataclass
class AsyncTrainingExecutor:
    loss_fn: Callable[[list, Any], Any]      # (per-layer params list, batch)
    num_stages: int
    assignment: list[int]                    # layers per stage (sums to L)
    update_fn: Callable[[list, list, Any], tuple[list, Any]]
    opt_state: Any
    aggregate_every: int = 0                 # 0 = off (PipeDream semantics)
    aggregate_op: Optional[Callable[[int, list], Any]] = None
    #   (layer, [candidate trees]) -> mean tree. None = plain ``tree_mean``
    #   over the leaves; ``fleet.layer_aggregate_op`` routes it through the
    #   live runtime's packed-flat-buffer mean
    #   (``stage_executor.aggregate_packed``) instead, so this oracle and
    #   the live/fleet runtimes aggregate with the SAME arithmetic.

    def __post_init__(self):
        n = self.num_stages
        self.stash = VersionedWeights(depth=n + 1)
        self._layer_stage = []
        for s, c in enumerate(self.assignment):
            self._layer_stage += [s] * c

    def _mean_layer(self, layer: int, trees: list):
        if self.aggregate_op is not None:
            return self.aggregate_op(layer, trees)
        return tree_mean(trees)

    def _aggregate(self, params: list) -> list:
        """Per-stage windowed mean over the last (n - i) live versions."""
        n = self.num_stages
        live = self.stash.live_versions()
        out = [None] * len(params)
        for layer, s in enumerate(self._layer_stage):
            k = max(1, min(n - s, len(live)))
            versions = live[-k:]
            out[layer] = self._mean_layer(
                layer, [self.stash.versions[v][layer] for v in versions])
        return out

    def run(self, params: list, batches: list, *,
            on_step: Optional[Callable] = None) -> tuple[list, list[float]]:
        """Train through `batches` under async semantics; returns
        (final params, per-batch losses)."""
        n = self.num_stages
        assert sum(self.assignment) == len(params), \
            (self.assignment, len(params))
        M = len(batches)
        counter = 0
        self.stash.put(0, params)
        ver_f: dict[int, int] = {}
        losses = np.zeros(M)
        backwards = 0

        for op in sched.stage_schedule(0, n, M):
            if op.kind == "fwd":
                ver_f[op.batch] = counter
                continue
            b = op.batch
            w_used = self.stash.get(ver_f[b])
            loss, grads = value_and_grad(self.loss_fn, w_used, batches[b])
            losses[b] = loss.item()
            newest = self.stash.newest()
            new_params, self.opt_state = self.update_fn(newest, grads,
                                                        self.opt_state)
            counter += 1
            self.stash.put(counter, new_params)
            backwards += 1
            if self.aggregate_every and backwards % self.aggregate_every == 0:
                agg = self._aggregate(new_params)
                counter += 1
                self.stash.put(counter, agg)
            if on_step is not None:
                on_step(b, float(losses[b]))
        return self.stash.newest(), list(losses)
