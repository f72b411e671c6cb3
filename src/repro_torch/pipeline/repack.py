"""Dynamic re-partition of stacked pipeline parameters: re-pack them under
a new layer -> stage assignment (paper §III-D/III-F, mapped onto the
stacked-slot representation).

The port of ``repro.pipeline.repack``. The stacked layout holds layer ℓ at
(stage s, slot j), where s and j follow the assignment's contiguous
ranges; pad slots are masked. A re-partition (or a stage loss) changes the
assignment: this module computes, per (stage, slot), which OLD (stage,
slot) its weights come from (Algorithm 1's ``need`` map) and builds each
new stacked leaf by gathering those rows over the stage axis. The moved
bytes equal the redistribution plan's transfer volume. The leaves passed
in are not written.

Only uniform slot layouts can re-pack arbitrarily (dense/moe/vlm
families); heterogeneous layouts (hybrid/ssm/audio) keep the fixed
balanced assignment.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch

from repro_torch import tree
from repro_torch.configs.base import ModelConfig


def uniform_layout(cfg: ModelConfig) -> bool:
    return len(set(cfg.slot_layout)) == 1


def slot_of(assignment: Sequence[int], layer: int) -> tuple[int, int]:
    """(stage, slot) holding ``layer`` under ``assignment``."""
    acc = 0
    for s, n in enumerate(assignment):
        if layer < acc + n:
            return s, layer - acc
        acc += n
    raise ValueError(layer)


@dataclasses.dataclass(frozen=True)
class RepackPlan:
    """For each (new stage s, slot j): the (old stage, old slot) source, or
    (-1, -1) for pad slots (left as-is)."""
    src: np.ndarray            # [S, Lps, 2] int
    moved_layers: int          # how many layers change stage (transfer cost)

    @property
    def stages(self):
        return self.src.shape[0]


def make_repack_plan(cfg: ModelConfig, old_assignment: Sequence[int],
                     new_assignment: Sequence[int]) -> RepackPlan:
    if not uniform_layout(cfg):
        raise ValueError(f"{cfg.name}: a heterogeneous layout cannot "
                         f"re-pack across slot types")
    S, Lps = cfg.pipeline_stages, cfg.layers_per_stage
    if sum(old_assignment) != sum(new_assignment):
        raise ValueError(f"{old_assignment} and {new_assignment} hold "
                         f"different layer counts")
    if len(new_assignment) != S or max(new_assignment) > Lps:
        raise ValueError(f"{new_assignment} does not fit {S} stages of "
                         f"{Lps} slots")
    src = np.full((S, Lps, 2), -1, int)
    moved = 0
    for layer in range(sum(new_assignment)):
        os_, oj = slot_of(old_assignment, layer)
        ns, nj = slot_of(new_assignment, layer)
        src[ns, nj] = (os_, oj)
        if os_ != ns:
            moved += 1
    return RepackPlan(src=src, moved_layers=moved)


def repack_blocks(blocks, plan: RepackPlan, cfg: ModelConfig):
    """blocks: list over slots of stage-stacked trees (leaves [S, ...]).
    Returns the re-packed list of new leaves. Pad-destination slots keep
    their old values (they are masked out by the pad mask anyway)."""
    S, Lps = plan.src.shape[:2]
    out = []
    for j in range(Lps):
        # new slot j at stage s comes from old (src_stage, src_slot)
        src_stage = [int(plan.src[s, j, 0]) if plan.src[s, j, 0] >= 0
                     else s for s in range(S)]
        src_slot = [int(plan.src[s, j, 1]) if plan.src[s, j, 1] >= 0
                    else j for s in range(S)]

        def gather_leaf(*leaves_per_slot):
            # leaves_per_slot[q][s] = old slot q's stage-s leaf
            return torch.stack([leaves_per_slot[src_slot[s]][src_stage[s]]
                                for s in range(S)])

        out.append(tree.map(gather_leaf, *blocks))
    return out


def redistribution_bytes(cfg: ModelConfig, plan: RepackPlan,
                         bytes_per_layer: float) -> float:
    """Transfer volume of the re-pack = Algorithm 1's fetch bytes."""
    return plan.moved_layers * bytes_per_layer


def repartition_from_profile(cfg: ModelConfig, layer_times, out_bytes,
                             capacities, bandwidths):
    """Solve the paper's DP for per-stage layer counts, clipped to the slot
    budget (layers_per_stage) so the result is representable."""
    from repro_torch.core.partition import solve_partition
    r = solve_partition(layer_times, out_bytes, capacities, bandwidths)
    counts = list(r.counts)
    # clip to slot budget, pushing overflow to the lightest neighbor
    Lps = cfg.layers_per_stage
    for s in range(len(counts)):
        while counts[s] > Lps:
            counts[s] -= 1
            tgt = min(((t, c) for t, c in enumerate(counts) if c < Lps),
                      key=lambda x: x[1])[0]
            counts[tgt] += 1
    return counts


def recover_assignment_after_stage_loss(cfg: ModelConfig,
                                        old_assignment: Sequence[int],
                                        lost_stage: int) -> list[int]:
    """Fault recovery: redistribute the lost stage's layers over the
    surviving slot budget, preferring the paper's balanced fill (survivors
    with spare slots take over, ordered by load)."""
    S, Lps = cfg.pipeline_stages, cfg.layers_per_stage
    counts = list(old_assignment)
    orphans = counts[lost_stage]
    counts[lost_stage] = 0
    while orphans:
        candidates = [s for s in range(S)
                      if s != lost_stage and counts[s] < Lps]
        if not candidates:
            raise ValueError("no slot budget left to absorb the lost stage")
        tgt = min(candidates, key=lambda s: counts[s])
        counts[tgt] += 1
        orphans -= 1
    return counts
