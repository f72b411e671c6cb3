"""Shared FTPipeHD protocol-event layer: ONE source of truth for WHEN control
events happen and WHAT they decide, used by both runtimes:

  * ``runtime/simulator.py`` — predicts timing on a virtual clock,
  * ``runtime/live.py``      — executes the same decisions on real JAX
                               computations over ``runtime/transport.py``.

Both runtimes iterate the batch axis in control-free segments delimited by
``control_points`` and apply control events (replication cadence from
``core/replication.py``, dynamic re-partition §III-D, failure recovery
§III-F) at batch boundaries with a pipeline drain.  For the simulator this
is a documented approximation; for the live runtime it is the actual
execution strategy, which is what keeps the two in lock-step: same inputs
-> same partitions, same replication schedule, same recovery plan.

Decision helpers delegate to the unit-tested core modules
(``core/partition.py``, ``core/capacity.py``, ``core/redistribution.py``,
``core/fault.py``); cost helpers price those decisions for the simulator.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np

from repro_torch.core import redistribution as rd
from repro_torch.core.capacity import CapacityEstimator
from repro_torch.core.partition import (PartitionResult, solve_partition,
                                        uniform_partition)
from repro_torch.core.replication import should_chain, should_global


@dataclasses.dataclass(frozen=True)
class ProtocolConfig:
    """Control-event cadence + fault-detection knobs (paper §III-D/E/F)."""
    chain_every: int = 50                 # §IV-B replication cadence
    global_every: int = 100
    repartition_first_at: int = 10        # §III-D: first re-partition
    repartition_every: int = 100
    detect_timeout: float = 1.0           # §III-F fault timer
    probe_rtt: float = 0.05
    commit_rtt: float = 0.05
    comm_factor: float = 2.0              # fwd activation + bwd gradient
    # Refit hysteresis (beyond-paper, for jittery WAN capacity samples):
    # None = the paper's behavior, adopt any partition whose cut points
    # changed. A float h >= 0 only adopts when the predicted saving over
    # the next control interval exceeds (1 + h) x the redistribution
    # cost (see ``refit_worthwhile``), so noise-driven flapping is
    # suppressed while a genuine capacity shift still refits at the
    # first due batch.
    refit_hysteresis: Optional[float] = None
    # Fleet weight-aggregation barrier cadence (data-parallel chains,
    # ROADMAP direction 2): every ``fleet_every`` committed batches the
    # chain syncs its global replica and contributes it to the fleet-wide
    # per-layer average. 0 = single-chain run, no barrier.
    fleet_every: int = 0
    # Overlap-everything scheduler (ROADMAP direction 5): a due replication
    # leaves the control point as a SNAPSHOT plus an immediate ack; the
    # replica bytes ship during the next segment's compute instead of
    # inside the drain. Seeding rounds (batch 0, post-admission re-seed)
    # and barrier rounds (fleet sync, final collect) still drain — their
    # callers need the receiving store complete before the next decision.
    overlap_replication: bool = False

    def replication_mode(self, *, seeding: bool = False,
                         barrier: bool = False) -> str:
        """``'overlap' | 'drain'`` for a replication at a control point.
        ONE decision point shared by the live coordinator and the
        simulator, so the simulator keeps predicting what live executes
        when ``overlap_replication`` is on."""
        if self.overlap_replication and not (seeding or barrier):
            return "overlap"
        return "drain"

    def replication_blocking_cost(self, chain_c: float,
                                  global_c: float, *,
                                  seeding: bool = False,
                                  barrier: bool = False) -> float:
        """Wall-clock a replication round holds the pipeline drained for.
        Drain mode pays the full serialized transfer; overlap mode pays
        only the snapshot + ack round trip (the bytes ride the next
        segment) — capped at the drain cost, since snapshotting a slice
        can never hold the pipeline longer than also shipping it."""
        if self.replication_mode(seeding=seeding,
                                 barrier=barrier) == "overlap":
            return min(self.commit_rtt, chain_c + global_c)
        return chain_c + global_c

    def replication_due(self, batch: int) -> tuple[bool, bool]:
        """(chain, global) replication due at this batch boundary."""
        return (should_chain(batch, self.chain_every),
                should_global(batch, self.global_every))

    def repartition_due(self, batch: int) -> bool:
        return (batch == self.repartition_first_at
                or (batch > 0 and batch % self.repartition_every == 0))

    def fleet_due(self, batch: int) -> bool:
        """Fleet aggregation barrier due at this batch boundary."""
        return (self.fleet_every > 0 and batch > 0
                and batch % self.fleet_every == 0)

    def control_points(self, num_batches: int, *, dynamic: bool = True,
                       extra: Sequence[int] = ()) -> list[int]:
        """Sorted batch indices (< num_batches) where the pipeline drains for
        a control event. ``dynamic=False`` drops the re-partition points
        (static baselines: PipeDream / ResPipe)."""
        pts = set(extra)
        for k in range(1, num_batches // self.chain_every + 1):
            pts.add(k * self.chain_every)
        for k in range(1, num_batches // self.global_every + 1):
            pts.add(k * self.global_every)      # global need not align w/ chain
        if self.fleet_every > 0:
            for k in range(1, num_batches // self.fleet_every + 1):
                pts.add(k * self.fleet_every)   # fleet barriers drain too
        if dynamic:
            pts.add(self.repartition_first_at)
            for k in range(1, num_batches // self.repartition_every + 1):
                pts.add(k * self.repartition_every)
        return sorted(p for p in pts if 0 < p < num_batches)


# --------------------------- decision helpers ----------------------------

def aggregation_ready(live: Sequence[int], arrived: Sequence[int],
                      waited: float,
                      deadline: float) -> tuple[bool, frozenset]:
    """Fleet-barrier readiness (data-parallel chains): should the round
    publish NOW, and which live chains get degraded for missing it?

    * every live chain arrived                 -> publish, degrade nobody;
    * deadline elapsed and >= 1 chain arrived  -> publish over the arrivals,
      degrade the stragglers (the fleet runs at M-1 until they re-admit);
    * otherwise                                -> keep waiting.

    Pure so both transports (and the tests) share one decision — parity
    between queue and TCP fleets falls out of this function.
    """
    live_s, arrived_s = frozenset(live), frozenset(arrived)
    if live_s and live_s <= arrived_s:
        return True, frozenset()
    if waited >= deadline and arrived_s:
        return True, live_s - arrived_s
    return False, frozenset()

def _estimated_caps(worker_ids: Sequence[int],
                    est: CapacityEstimator) -> np.ndarray:
    """Capacity vector the solver sees: the estimator's view normalized to
    C_0 = 1 (Eq. 1), or all-ones before every worker has reported
    (paper §III-B / §III-F homogeneity assumption)."""
    n = len(worker_ids)
    if est.all_reported():
        caps = np.asarray(est.capacities[:n], float)
        return caps / caps[0] if caps[0] > 0 else caps
    return np.ones(n)


def solve_from_estimates(profile, bandwidth: np.ndarray,
                         worker_ids: Sequence[int], est: CapacityEstimator,
                         comm_factor: float = 2.0, *,
                         static: bool = False) -> PartitionResult:
    """Dynamic partition (Eqs. 4-7) from the capacity estimator's current
    view. ``static=True`` ignores the estimates and returns PipeDream's
    equal split (the paper's static baseline) — recovery still re-splits
    over the survivor count, but never adapts to heterogeneity."""
    n = len(worker_ids)
    if static:
        return uniform_partition(len(profile.exec_times), n)
    caps = _estimated_caps(worker_ids, est)
    bws = np.array([bandwidth[worker_ids[i], worker_ids[i + 1]]
                    for i in range(n - 1)])
    return solve_partition(profile.exec_times, profile.out_bytes, caps, bws,
                           comm_factor)


def partition_cycle_time(profile, bandwidth: np.ndarray,
                         worker_ids: Sequence[int], est: CapacityEstimator,
                         part: PartitionResult,
                         comm_factor: float = 2.0) -> float:
    """Price an EXISTING partition under the estimator's CURRENT view:
    the DP objective (max over capacity-scaled stage times and inter-stage
    comm terms) evaluated at ``part``'s cut points. Shares the
    normalization of ``solve_from_estimates`` so the two are directly
    comparable — ``partition_cycle_time(.., solve_from_estimates(..))``
    equals that solution's bottleneck."""
    caps = _estimated_caps(worker_ids, est)
    lt = np.asarray(profile.exec_times, float)
    ob = np.asarray(profile.out_bytes, float)
    t, start = 0.0, 0
    for i, p in enumerate(part.points):
        t = max(t, float(np.sum(lt[start:p + 1])) * caps[i])
        if i < len(part.points) - 1:
            bw = bandwidth[worker_ids[i], worker_ids[i + 1]]
            t = max(t, comm_factor * ob[p] / bw)
        start = p + 1
    return t


def refit_worthwhile(profile, bandwidth: np.ndarray,
                     worker_ids: Sequence[int], est: CapacityEstimator,
                     part_cur: PartitionResult, part_new: PartitionResult,
                     proto: "ProtocolConfig") -> bool:
    """Should the runtime ADOPT ``part_new`` over ``part_cur``? With
    ``proto.refit_hysteresis`` unset: yes whenever the cut points differ
    (the paper's rule). With hysteresis h: only when the predicted saving
    over the next ``repartition_every`` batches exceeds (1 + h) x the
    redistribution cost of moving the weights, so jitter-sized estimate
    wobbles (which re-cut by one layer but save microseconds) never pay
    a multi-second weight reshuffle."""
    if part_new.points == part_cur.points:
        return False
    h = proto.refit_hysteresis
    if h is None:
        return True
    t_cur = partition_cycle_time(profile, bandwidth, worker_ids, est,
                                 part_cur, proto.comm_factor)
    t_new = partition_cycle_time(profile, bandwidth, worker_ids, est,
                                 part_new, proto.comm_factor)
    gain = (t_cur - t_new) * proto.repartition_every
    plans = plan_repartition_all(part_new, part_cur, len(worker_ids))
    cost = redistribution_cost(profile, bandwidth, list(worker_ids), plans,
                               proto.commit_rtt)
    return gain > (1.0 + h) * cost


@dataclasses.dataclass
class RecoveryDecision:
    """Everything both runtimes need to act on a failure (§III-F)."""
    worker_ids: list                     # renumbered (survivors, in order)
    partition: PartitionResult           # recovery partition
    plans: list[rd.RedistributionPlan]   # per NEW worker index
    est: CapacityEstimator               # estimator over the survivor list


def plan_failure_recovery(part_cur: PartitionResult, worker_ids: Sequence,
                          failed_positions: Sequence[int],
                          est: CapacityEstimator, profile,
                          bandwidth: np.ndarray, comm_factor: float = 2.0,
                          holder_has=None, *,
                          static: bool = False) -> RecoveryDecision:
    """§III-F single/multi failure: renumber the worker list, re-solve the
    partition over the survivors, and emit per-survivor redistribution plans
    (Algorithm 1 via ``core/fault.py``). ``failed_positions`` are indices
    into the CURRENT list; ``holder_has(new_idx, layer)`` (multi-failure
    only) says whether a survivor can serve a layer — the central global
    replica (index 0) is the backstop."""
    from repro_torch.core.fault import recovery_plans
    new_ids = rd.update_worker_list(list(worker_ids), list(failed_positions))
    new_est = est.drop_workers(list(failed_positions))
    new_part = solve_from_estimates(profile, bandwidth, new_ids, new_est,
                                    comm_factor, static=static)
    if holder_has is None:
        holder_has = lambda idx, l: idx == 0   # central-only fallback
    plans = recovery_plans(new_part.points, part_cur.points,
                           list(failed_positions), len(worker_ids),
                           holder_has=holder_has)
    return RecoveryDecision(worker_ids=new_ids, partition=new_part,
                            plans=plans, est=new_est)


def plan_repartition_all(p_new: PartitionResult, p_cur: PartitionResult,
                         num_workers: int) -> list[rd.RedistributionPlan]:
    """Dynamic re-partition (§III-D): per-worker fetch plans, no failure."""
    return [rd.plan_repartition(p_new.points, p_cur.points, i)
            for i in range(num_workers)]


def plan_admission(p_new: PartitionResult, p_cur: PartitionResult,
                   n_old: int) -> list[rd.RedistributionPlan]:
    """Elastic admission (rejoin / hot-join): redistribution plans for a
    worker list GROWN from ``n_old`` to ``len(p_new.ranges)`` stages, with
    joiners appended at the end so every existing worker keeps its index.

    Existing workers plan exactly like a §III-D re-partition (fetch from
    the old holder of each newly assigned layer). A joiner holds nothing:
    every layer of its new range is fetched from its old-partition holder
    — whose index is unchanged in the grown list — with the §III-F
    fallbacks (chain replica, then the central global store) covering a
    holder that re-partitioned the layer away in the meantime."""
    plans = [rd.plan_repartition(p_new.points, p_cur.points, i)
             for i in range(n_old)]
    for i in range(n_old, len(p_new.ranges)):
        a, e = p_new.ranges[i]
        need: dict[int, list[int]] = {}
        for l in range(a, e + 1):
            need.setdefault(rd.holder_of(p_cur.points, l), []).append(l)
        plans.append(rd.RedistributionPlan(need=need, local=[]))
    return plans


def expand_bandwidth(bandwidth: np.ndarray, n_new: int) -> np.ndarray:
    """Grow an N x N bandwidth matrix to ``n_new`` x ``n_new`` for links to
    a hot-joined device the matrix never described: new entries take the
    median of the existing off-diagonal links (the matrix is what the
    central node measured; a never-seen device gets the typical link until
    measured)."""
    n = bandwidth.shape[0]
    if n_new <= n:
        return bandwidth
    off = bandwidth[~np.eye(n, dtype=bool)]
    finite = off[np.isfinite(off)]
    fill = float(np.median(finite)) if finite.size else 1e7
    out = np.full((n_new, n_new), fill)
    out[:n, :n] = bandwidth
    np.fill_diagonal(out, np.inf)
    return out


def respipe_takeover(part: PartitionResult, failed: int) -> PartitionResult:
    """ResPipe baseline: the failed stage's layers are absorbed by its
    successor (or predecessor for the last stage) — no re-split."""
    counts = list(part.counts)
    if failed + 1 < len(counts):
        counts = (counts[:failed] + [counts[failed] + counts[failed + 1]]
                  + counts[failed + 2:])
    else:
        counts = counts[:failed - 1] + [counts[failed - 1] + counts[failed]]
    pts, acc = [], -1
    for c in counts:
        acc += c
        pts.append(acc)
    return PartitionResult(tuple(pts), tuple(counts), float("nan"))


# ----------------------------- cost helpers ------------------------------
# Used by the simulator to price the decisions above; the live runtime pays
# these costs in wall-clock instead.

def stage_weight_bytes(profile, part: PartitionResult, stage: int) -> float:
    a, b = part.ranges[stage]
    return float(np.sum(profile.weight_bytes[a:b + 1]))


def chain_cost(profile, bandwidth, part: PartitionResult,
               worker_ids: Sequence[int]) -> float:
    """All workers replicate to their neighbor in parallel -> max."""
    n = len(worker_ids)
    return max(stage_weight_bytes(profile, part, s)
               / bandwidth[worker_ids[s], worker_ids[(s + 1) % n]]
               for s in range(n))

def global_cost(profile, bandwidth, part: PartitionResult,
                worker_ids: Sequence[int]) -> float:
    """Workers 1..N-1 send to central — serialized on central's link."""
    return sum(stage_weight_bytes(profile, part, s)
               / bandwidth[worker_ids[s], worker_ids[0]]
               for s in range(1, len(worker_ids)))


def redistribution_cost(profile, bandwidth, worker_ids_new: Sequence[int],
                        plans: Sequence[rd.RedistributionPlan],
                        commit_rtt: float) -> float:
    """Parallel fetches -> max per-worker transfer + commit round."""
    wb = profile.weight_bytes
    per_worker = []
    for i_new, plan in enumerate(plans):
        t = 0.0
        for target, layers in plan.need.items():
            bw = bandwidth[worker_ids_new[target], worker_ids_new[i_new]]
            t += sum(wb[l] for l in layers) / bw
        per_worker.append(t)
    return (max(per_worker) if per_worker else 0.0) + commit_rtt
