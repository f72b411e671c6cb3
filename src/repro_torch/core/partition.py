"""Dynamic model partition: PipeDream's DP extended with per-worker
computing capacities (paper §III-D, Eqs. 4-7).

    A(j, 1) = T^0(0, j)
    A(j, n) = min_{1<=l<j} max( A(l, n-1),
                                2 * T_c(l, n-2),      # activation + gradient
                                T^{n-1}(l+1, j) )
    T^i(a, b) = sum_m T_e,m^0 * C_i          (Eq. 3: capacity-scaled)
    T_c,j^i   = D_j / B_{i,i+1}              (Eq. 6)

Workers are ordered by the worker list; worker 0 is the central node with
C_0 = 1 by definition (Eq. 1 normalizes against it).
"""
from __future__ import annotations

import dataclasses
import numpy as np


@dataclasses.dataclass(frozen=True)
class PartitionResult:
    points: tuple[int, ...]       # p_i = last layer index of stage i (len N)
    counts: tuple[int, ...]       # layers per stage (len N)
    bottleneck: float             # pipeline bottleneck time (the DP objective)

    @property
    def ranges(self) -> list[tuple[int, int]]:
        """[start, end] inclusive per stage."""
        out, start = [], 0
        for p in self.points:
            out.append((start, p))
            start = p + 1
        return out


def stage_time(layer_times, capacity: float, start: int, end: int) -> float:
    """T^i(start, end): capacity-scaled execution time, inclusive range."""
    return float(np.sum(layer_times[start:end + 1])) * capacity


def solve_partition(layer_times, out_sizes, capacities, bandwidths,
                    comm_factor: float = 2.0) -> PartitionResult:
    """Solve the paper's DP.

    layer_times: [L] central-node fwd+bwd time per layer (T_e,j^0)
    out_sizes:   [L] output bytes per layer (D_j)
    capacities:  [N] per-worker capacity C_i (C_0 = 1.0 by convention)
    bandwidths:  [N-1] B_{i,i+1} bytes/s between consecutive workers
    """
    layer_times = np.asarray(layer_times, float)
    out_sizes = np.asarray(out_sizes, float)
    capacities = np.asarray(capacities, float)
    L, N = len(layer_times), len(capacities)
    assert N >= 1 and L >= N, (L, N)

    prefix = np.concatenate([[0.0], np.cumsum(layer_times)])

    def seg(a, b, cap):                      # T^i(a, b), inclusive
        return (prefix[b + 1] - prefix[a]) * cap

    INF = float("inf")
    A = np.full((L, N + 1), INF)
    arg = np.full((L, N + 1), -1, int)
    for j in range(L):
        A[j, 1] = seg(0, j, capacities[0])

    for n in range(2, N + 1):
        cap = capacities[n - 1]
        for j in range(n - 1, L):
            best, besti = INF, -1
            for l in range(n - 2, j):        # sub-pipeline covers 0..l
                if A[l, n - 1] == INF:
                    continue
                comm = comm_factor * out_sizes[l] / bandwidths[n - 2]
                t = max(A[l, n - 1], comm, seg(l + 1, j, cap))
                if t < best:
                    best, besti = t, l
            A[j, n] = best
            arg[j, n] = besti

    # reconstruct
    points = [L - 1]
    j, n = L - 1, N
    while n > 1:
        l = arg[j, n]
        points.append(l)
        j, n = l, n - 1
    points = tuple(sorted(points))
    counts = tuple(p - q for p, q in zip(points, (-1,) + points[:-1]))
    return PartitionResult(points=points, counts=counts,
                           bottleneck=float(A[L - 1, N]))


def brute_force_partition(layer_times, out_sizes, capacities, bandwidths,
                          comm_factor: float = 2.0) -> PartitionResult:
    """Exhaustive oracle for tests (enumerate all contiguous N-splits)."""
    import itertools

    layer_times = np.asarray(layer_times, float)
    out_sizes = np.asarray(out_sizes, float)
    L, N = len(layer_times), len(capacities)
    best, best_pts = float("inf"), None
    for cut in itertools.combinations(range(L - 1), N - 1):
        pts = list(cut) + [L - 1]
        start, t = 0, 0.0
        for i, p in enumerate(pts):
            t = max(t, stage_time(layer_times, capacities[i], start, p))
            if i < N - 1:
                t = max(t, comm_factor * out_sizes[p] / bandwidths[i])
            start = p + 1
        if t < best:
            best, best_pts = t, tuple(pts)
    counts = tuple(p - q for p, q in zip(best_pts, (-1,) + best_pts[:-1]))
    return PartitionResult(points=best_pts, counts=counts, bottleneck=best)


def solve_fleet_partitions(layer_times, out_sizes, chain_capacities,
                           chain_bandwidths,
                           comm_factor: float = 2.0) -> list[PartitionResult]:
    """Per-chain §III-D over a fleet of M replicated pipelines: each chain
    solves the DP over ITS OWN device capacities and links, so a fleet of
    heterogeneous clusters stays balanced chain-by-chain — there is no
    cross-chain coupling in the objective (chains only meet at the weight-
    aggregation barrier, which is partition-agnostic on per-layer slices).

    chain_capacities: [M][N_m] per-chain capacity vectors (possibly ragged)
    chain_bandwidths: [M][N_m - 1] per-chain consecutive-link bandwidths
    """
    assert len(chain_capacities) == len(chain_bandwidths)
    return [solve_partition(layer_times, out_sizes, caps, bws, comm_factor)
            for caps, bws in zip(chain_capacities, chain_bandwidths)]


def uniform_partition(num_layers: int, num_workers: int) -> PartitionResult:
    """PipeDream's initial homogeneous split (paper §III-B: 'assumes all the
    worker nodes have the same computing resources')."""
    base, extra = divmod(num_layers, num_workers)
    counts, points, acc = [], [], -1
    for i in range(num_workers):
        c = base + (1 if i < extra else 0)
        counts.append(c)
        acc += c
        points.append(acc)
    return PartitionResult(points=tuple(points), counts=tuple(counts),
                           bottleneck=float("nan"))
