"""Weight redistribution (paper Algorithm 1 + §III-F).

Given old/new partition points, each worker computes which of its newly
assigned layers it already holds (``local``) and from which worker to fetch
each missing one (``need``), correcting indices for the failed worker:

  * holders after the failed index shift down by one (worker list renumber);
  * layers owned by the failed worker are fetched from its chain-replica
    holder, which is ``failed + 1`` — the SAME index after renumbering
    (hence "target unchanged" in the paper), or the central node (index 0)
    when the LAST worker failed (its chain replica lives on the central).

``plan_repartition`` is the no-failure variant used by dynamic re-partition
(§III-D): no index correction.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence


@dataclasses.dataclass(frozen=True)
class RedistributionPlan:
    need: dict[int, list[int]]     # target worker index (new list) -> layers
    local: list[int]               # needed layers already held locally


def stage_range(points: Sequence[int], idx: int) -> tuple[int, int]:
    """Inclusive [start, end] layer range of stage ``idx`` given partition
    points (p_i = last layer of stage i)."""
    start = 0 if idx == 0 else points[idx - 1] + 1
    return start, points[idx]


def holder_of(points: Sequence[int], layer: int) -> int:
    """Stage index that owns ``layer`` under ``points``."""
    for i, p in enumerate(points):
        if layer <= p:
            return i
    raise ValueError(f"layer {layer} beyond partition {points}")


def plan_single_failure(p_new: Sequence[int], p_cur: Sequence[int],
                        i_fail: int, i_cur: int, i_new: int,
                        num_nodes: int) -> RedistributionPlan:
    """Paper Algorithm 1 (faithful). Indices: ``i_cur`` in the OLD worker
    list (length num_nodes), ``i_new`` in the new list; ``i_fail`` is the
    failed worker's OLD index; the central node never fails."""
    start_cur, end_cur = stage_range(p_cur, i_cur)
    start_new, end_new = stage_range(p_new, i_new)

    local, needed = [], []
    for l in range(start_new, end_new + 1):
        if start_cur <= l <= end_cur:
            local.append(l)
        else:
            needed.append(l)

    need: dict[int, list[int]] = {}
    last = num_nodes - 1
    for l in needed:
        t = holder_of(p_cur, l)
        if t > i_fail:
            t = t - 1
        elif t == i_fail and i_fail == last:
            t = 0                      # last stage's chain replica -> central
        # t == i_fail < last: unchanged — replica holder i_fail+1 renumbers
        # to i_fail.
        need.setdefault(t, []).append(l)
    return RedistributionPlan(need=need, local=local)


def plan_repartition(p_new: Sequence[int], p_cur: Sequence[int],
                     idx: int) -> RedistributionPlan:
    """Dynamic re-partition (no failure): fetch from the current holder,
    'an independent action without the scheduling of the central node'."""
    start_cur, end_cur = stage_range(p_cur, idx)
    start_new, end_new = stage_range(p_new, idx)
    local, need = [], {}
    for l in range(start_new, end_new + 1):
        if start_cur <= l <= end_cur:
            local.append(l)
        else:
            need.setdefault(holder_of(p_cur, l), []).append(l)
    return RedistributionPlan(need=need, local=local)


def update_worker_list(worker_list: Sequence, failed: Sequence[int]) -> list:
    """§III-F: single failure — indices above the failed shift down by one;
    multiple failures — each failed worker is substituted by its subsequent
    alive workers one by one. Both reduce to 'keep alive workers in order'."""
    failed_set = set(failed)
    return [w for i, w in enumerate(worker_list) if i not in failed_set]


def plan_multi_failure(p_new: Sequence[int], p_cur: Sequence[int],
                       failed: Sequence[int], i_new: int, num_nodes: int,
                       holder_has) -> RedistributionPlan:
    """Multiple failures (§III-F): map old holders onto the new list; if the
    target (or its chain replica holder) is also dead / lacks the weights,
    fall back to the central node's global replica (index 0).

    holder_has(new_idx, layer) -> bool: whether that worker can serve the
    layer (own weights or chain replica). The central node always can
    (global replication).
    """
    alive = [i for i in range(num_nodes) if i not in set(failed)]
    old_to_new = {old: new for new, old in enumerate(alive)}

    start_new, end_new = stage_range(p_new, i_new)
    my_old = alive[i_new]
    start_cur, end_cur = stage_range(p_cur, my_old)

    local, need = [], {}
    for l in range(start_new, end_new + 1):
        if start_cur <= l <= end_cur:
            local.append(l)
            continue
        t_old = holder_of(p_cur, l)
        if t_old in old_to_new and holder_has(old_to_new[t_old], l):
            t = old_to_new[t_old]
        else:
            # chain replica holder of the dead owner, if alive
            nxt = (t_old + 1) % num_nodes
            if nxt in old_to_new and holder_has(old_to_new[nxt], l):
                t = old_to_new[nxt]
            else:
                t = 0                  # central global replica
        need.setdefault(t, []).append(l)
    return RedistributionPlan(need=need, local=local)
