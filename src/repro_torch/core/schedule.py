"""Async 1F1B schedule semantics (paper §III-C, PipeDream rules).

Pure functions describing WHICH weight version each batch uses where —
the contract shared by the edge simulator (true async execution) and the
TPU pipeline (sync-within-step + cross-step stash). Property tests assert
the three PipeDream rules and the paper's Fig. 2 walkthrough against these.

Conventions (0-indexed batches, n = number of stages):
  * vertical sync:   batch b is forwarded AND backwarded everywhere with
                     version v(b) = max(0, b - n + 1).
  * weight stashing: stage i must retain versions {v(b) : b in flight at i},
                     which is at most n - i distinct versions.
  * 1F1B:            stage i runs forwards for batches 0..n-1-i before its
                     first backward, then strictly alternates.
"""
from __future__ import annotations

import dataclasses
from typing import Iterator


def version_for_batch(b: int, n: int) -> int:
    """Vertical-sync weight version used by batch b in an n-stage pipeline."""
    return max(0, b - n + 1)


def version_after_backward(b: int) -> int:
    """Weight version at a stage right after batch b's backward completes."""
    return b + 1


def warmup_forwards(stage: int, n: int) -> int:
    """#forwards stage runs before its first backward (1F1B startup)."""
    return n - stage


def stash_depth(stage: int, n: int) -> int:
    """Max #concurrent weight versions at stage (paper: 'n - i independent
    concurrent training')."""
    return n - stage


def in_flight_batches(stage: int, after_backward_of: int, n: int) -> list[int]:
    """Batches forwarded at `stage` but not yet backwarded, in steady state,
    right after batch `after_backward_of` finished its backward there."""
    lo = after_backward_of + 1
    hi = after_backward_of + (n - stage)
    return list(range(lo, hi + 1))


def aggregation_interval(stage: int, n: int, multiple: int = 1) -> int:
    """Paper: aggregate the n-i concurrent versions at an interval that is a
    multiple of n-i."""
    return max(1, (n - stage) * multiple)


@dataclasses.dataclass(frozen=True)
class Op:
    kind: str      # "fwd" | "bwd"
    batch: int
    version: int   # weight version used (vertical sync)


def stage_schedule(stage: int, n: int, num_batches: int) -> Iterator[Op]:
    """The 1F1B op sequence executed by one stage.

    Startup: (n - stage) forwards; then alternate bwd/fwd; drain with
    remaining backwards. Versions follow vertical sync.
    """
    warm = min(warmup_forwards(stage, n), num_batches)
    next_f, next_b = 0, 0
    for _ in range(warm):
        yield Op("fwd", next_f, version_for_batch(next_f, n))
        next_f += 1
    while next_b < num_batches:
        yield Op("bwd", next_b, version_for_batch(next_b, n))
        next_b += 1
        if next_f < num_batches:
            yield Op("fwd", next_f, version_for_batch(next_f, n))
            next_f += 1


def validate_schedule(ops: list[Op], stage: int, n: int) -> None:
    """Assert 1F1B + stashing + vertical-sync invariants (used by tests)."""
    seen_f, seen_b = set(), set()
    stash: dict[int, int] = {}
    max_stash = 0
    for op in ops:
        if op.kind == "fwd":
            assert op.batch not in seen_f
            assert op.version == version_for_batch(op.batch, n)
            seen_f.add(op.batch)
            stash[op.batch] = op.version
        else:
            assert op.batch in seen_f and op.batch not in seen_b
            assert stash.pop(op.batch) == op.version, "weight stashing violated"
            seen_b.add(op.batch)
        max_stash = max(max_stash, len(set(stash.values())))
        # 1F1B bound: in-flight forwards never exceed n - stage
        assert len(stash) <= n - stage, "1F1B in-flight bound violated"
    assert max_stash <= stash_depth(stage, n)
