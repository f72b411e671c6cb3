"""Fault-tolerance state machine (paper §III-F).

The central node owns this: a timer per forwarded batch; on expiry it
probes all workers, classifies the outcome into the paper's three cases,
and drives recovery (renumber -> re-partition -> redistribute -> commit ->
reset ids -> resume). The I/O (probing, fetching) is the runtime's job; the
decisions live here so they are unit-testable.
"""
from __future__ import annotations

import dataclasses
import enum
from typing import Optional, Sequence

from repro_torch.core import redistribution
from repro_torch.core.partition import PartitionResult, solve_partition, uniform_partition


class Case(enum.Enum):
    ALL_NORMAL = 1         # everyone responded healthy: just restart the batch
    ONE_RESTARTED = 2      # one worker restarted (lost state, kept its slot)
    FAILURES = 3           # one or more workers did not respond


@dataclasses.dataclass
class TrainingState:
    """Paper Table I state variables."""
    committed_forward_id: int = -1
    committed_backward_id: int = -1
    status: int = 0                      # 0 normal, 1 recovering
    learning_rate: float = 0.1
    epoch_number: int = 0
    batch_number: int = 0

    def enter_recovery(self):
        self.status = 1

    def reset_after_recovery(self, failed_batch: int):
        """Discard in-flight batches: both committed ids snap back to just
        before the batch whose gradients never arrived (§III-F last phase)."""
        self.committed_forward_id = failed_batch - 1
        self.committed_backward_id = failed_batch - 1
        self.status = 0


def classify(responses: dict[int, Optional[str]]) -> tuple[Case, list[int]]:
    """responses: worker -> 'ok' | 'restarted' | None (no response)."""
    dead = [w for w, r in responses.items() if r is None]
    if dead:
        return Case.FAILURES, dead
    restarted = [w for w, r in responses.items() if r == "restarted"]
    if restarted:
        return Case.ONE_RESTARTED, restarted
    return Case.ALL_NORMAL, []


def recovery_partition(layer_times, out_sizes, capacities, bandwidths,
                       have_profiles: bool, num_alive: int) -> PartitionResult:
    """§III-F: use the dynamic scheduler if execution times were collected,
    otherwise assume homogeneous workers (central-node profile only)."""
    if have_profiles:
        return solve_partition(layer_times, out_sizes, capacities[:num_alive],
                               bandwidths[:max(1, num_alive - 1)])
    return uniform_partition(len(layer_times), num_alive)


def recovery_plans(p_new: Sequence[int], p_cur: Sequence[int],
                   failed: Sequence[int], num_nodes: int,
                   holder_has=None) -> list[redistribution.RedistributionPlan]:
    """Per-surviving-worker redistribution plans (Algorithm 1 for one
    failure; generalized chain/global fallback for several)."""
    alive = [i for i in range(num_nodes) if i not in set(failed)]
    plans = []
    if len(failed) == 1:
        f = failed[0]
        for i_new, i_cur in enumerate(alive):
            plans.append(redistribution.plan_single_failure(
                p_new, p_cur, f, i_cur, i_new, num_nodes))
    else:
        assert holder_has is not None
        for i_new in range(len(alive)):
            plans.append(redistribution.plan_multi_failure(
                p_new, p_cur, failed, i_new, num_nodes, holder_has))
    return plans
