"""Weight replication policy (paper §III-E): chain + global.

Chain: worker i backs up its weights to worker i+1 (last -> central),
every ``chain_every`` batches. Global: every worker backs up to the central
node, every ``global_every`` batches (less frequent). The central node is
assumed not to fail (§III-E); its own protection is the periodic disk save.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional


def chain_target(worker: int, num_workers: int) -> int:
    """Where worker i's chain replica lives (i+1; last worker -> central 0)."""
    return (worker + 1) % num_workers


def should_chain(batch: int, chain_every: int) -> bool:
    return batch > 0 and batch % chain_every == 0


def should_global(batch: int, global_every: int) -> bool:
    return batch > 0 and batch % global_every == 0


@dataclasses.dataclass
class ReplicaStore:
    """In-memory replica bookkeeping shared by simulator + checkpoint layer.

    chain[w]  = (batch_id, weights of worker w held by chain_target(w))
    global_[w] = (batch_id, weights of worker w held by the central node)
    """
    chain: dict[int, tuple[int, Any]] = dataclasses.field(default_factory=dict)
    global_: dict[int, tuple[int, Any]] = dataclasses.field(default_factory=dict)

    def do_chain(self, worker: int, batch: int, weights: Any) -> None:
        self.chain[worker] = (batch, weights)

    def do_global(self, worker: int, batch: int, weights: Any) -> None:
        self.global_[worker] = (batch, weights)

    def recover(self, worker: int, alive_chain_holders: set[int],
                num_workers: int) -> Optional[tuple[int, Any, str]]:
        """Best available replica for a failed worker's weights.

        Chain replica is usable iff its holder survived; otherwise fall back
        to the central node's global replica (paper §III-F multi-failure).
        Returns (batch_id, weights, source) or None.
        """
        holder = chain_target(worker, num_workers)
        if worker in self.chain and (holder in alive_chain_holders or holder == 0):
            b, w = self.chain[worker]
            g = self.global_.get(worker)
            if g is None or g[0] <= b:
                return (b, w, "chain")
        if worker in self.global_:
            b, w = self.global_[worker]
            return (b, w, "global")
        return None

    def comm_bytes_chain(self, weights_bytes: int) -> int:
        return weights_bytes

    def comm_bytes_global(self, weights_bytes: int, num_workers: int) -> int:
        return weights_bytes * (num_workers - 1)
