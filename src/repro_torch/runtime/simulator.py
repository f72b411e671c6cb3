"""Event-driven timing simulator of the FTPipeHD protocol on a heterogeneous
edge cluster (virtual clock). Reproduces the paper's speed/fault experiments:

  * async 1F1B pipeline timing per stage (exact op-level dependency sim),
  * periodic chain/global weight replication pauses (Fig. 6 spikes),
  * dynamic re-partition at batch 10 then every 100 (paper §III-D),
  * failure injection + detection timeout + recovery (FTPipeHD weight
    redistribution vs ResPipe take-over policy; Table III / Fig. 6),
  * baselines: static-PipeDream partitioning, single-device training.

Within control-free segments the pipeline is simulated exactly; control
events (replication, re-partition, recovery) happen at batch boundaries with
a drain — a small, documented approximation (DESIGN.md §6).

Protocol sharing: every control DECISION (when to replicate/re-partition,
which partition, which redistribution plans) comes from
``runtime/protocol.py`` — the same layer ``runtime/live.py`` executes
against real stage computations. This simulator only adds the virtual
clock: it prices the shared decisions with ``protocol.chain_cost`` /
``global_cost`` / ``redistribution_cost`` instead of paying them in
wall-clock. Because both runtimes drain at the same
``ProtocolConfig.control_points`` and call the same planners, the simulator
PREDICTS what the live runtime EXECUTES (see tests/test_torch_live.py).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from repro_torch.core import redistribution as rd
from repro_torch.core import schedule as sched
from repro_torch.core.capacity import CapacityEstimator
from repro_torch.core.partition import (PartitionResult, solve_partition,
                                        uniform_partition)
from repro_torch.runtime import protocol
from repro_torch.runtime.devices import DeviceSpec, WorkloadProfile


@dataclasses.dataclass
class SimConfig:
    devices: list[DeviceSpec]
    profile: WorkloadProfile
    bandwidth: np.ndarray                 # [N, N] bytes/s
    policy: str = "ftpipehd"              # ftpipehd | pipedream | respipe
    num_batches: int = 300
    chain_every: int = 50                 # paper §IV-B
    global_every: int = 100
    repartition_first_at: int = 10
    repartition_every: int = 100
    detect_timeout: float = 1.0           # fault timer (s)
    probe_rtt: float = 0.05
    commit_rtt: float = 0.05
    comm_factor: float = 2.0              # fwd activation + bwd gradient
    overlap_replication: bool = False     # §III-E off the critical path

    @property
    def protocol(self) -> protocol.ProtocolConfig:
        return protocol.ProtocolConfig(
            chain_every=self.chain_every, global_every=self.global_every,
            repartition_first_at=self.repartition_first_at,
            repartition_every=self.repartition_every,
            detect_timeout=self.detect_timeout, probe_rtt=self.probe_rtt,
            commit_rtt=self.commit_rtt, comm_factor=self.comm_factor,
            overlap_replication=self.overlap_replication)


@dataclasses.dataclass
class SimResult:
    batch_done: np.ndarray                # absolute completion time per batch
    batch_times: np.ndarray               # per-batch deltas (the Fig. 6 series)
    total_time: float
    events: list[tuple[float, str]]
    partitions: list[tuple[int, tuple[int, ...]]]   # (from_batch, points)
    recovery_overhead: float = 0.0

    def steady_batch_time(self, lo_frac=0.5, hi_frac=0.9) -> float:
        n = len(self.batch_times)
        seg = np.sort(self.batch_times[int(n * lo_frac):int(n * hi_frac)])
        return float(np.median(seg)) if len(seg) else float("nan")


class PipelineSimulator:
    def __init__(self, cfg: SimConfig):
        self.cfg = cfg
        self.proto = cfg.protocol
        self.capacities = np.array([d.capacity for d in cfg.devices])
        self._batch_now = 0            # for time-varying capacities

    def _caps_now(self):
        return np.array([d.capacity_at(self._batch_now)
                         for d in self.cfg.devices])

    # ---------------- exact 1F1B segment simulation ---------------------

    def _segment(self, part: PartitionResult, worker_ids: list[int],
                 num_batches: int, t0: float) -> tuple[np.ndarray, float]:
        """Simulate `num_batches` through the pipeline; returns (completion
        times at stage 0, drain end time)."""
        cfg = self.cfg
        N = len(worker_ids)
        caps = self._caps_now()[worker_ids]
        ranges = part.ranges
        fwd_t = np.array([np.sum(cfg.profile.fwd_times[a:b + 1]) * caps[i]
                          for i, (a, b) in enumerate(ranges)])
        bwd_t = np.array([np.sum(cfg.profile.bwd_times[a:b + 1]) * caps[i]
                          for i, (a, b) in enumerate(ranges)])
        comm = np.zeros(max(N - 1, 1))
        for i in range(N - 1):
            bw = cfg.bandwidth[worker_ids[i], worker_ids[i + 1]]
            comm[i] = cfg.profile.out_bytes[ranges[i][1]] / bw

        if N == 1:
            done = t0 + np.cumsum(np.full(num_batches, fwd_t[0] + bwd_t[0]))
            return done, float(done[-1]) if num_batches else t0

        ops = [list(sched.stage_schedule(s, N, num_batches)) for s in range(N)]
        ptr = [0] * N
        free = [t0] * N
        fwd_ready = [dict() for _ in range(N)]
        bwd_ready = [dict() for _ in range(N)]
        for b in range(num_batches):
            fwd_ready[0][b] = t0
        batch_done = np.full(num_batches, np.nan)

        remaining = sum(len(o) for o in ops)
        while remaining:
            progressed = False
            for s in range(N):
                while ptr[s] < len(ops[s]):
                    op = ops[s][ptr[s]]
                    if op.kind == "fwd":
                        dep = fwd_ready[s].get(op.batch)
                        if dep is None:
                            break
                        done = max(dep, free[s]) + fwd_t[s]
                        free[s] = done
                        if s < N - 1:
                            fwd_ready[s + 1][op.batch] = done + comm[s]
                        else:
                            bwd_ready[s][op.batch] = done
                    else:
                        dep = bwd_ready[s].get(op.batch)
                        if dep is None:
                            break
                        done = max(dep, free[s]) + bwd_t[s]
                        free[s] = done
                        if s > 0:
                            bwd_ready[s - 1][op.batch] = done + comm[s - 1]
                        else:
                            batch_done[op.batch] = done
                    ptr[s] += 1
                    remaining -= 1
                    progressed = True
            assert progressed, "pipeline deadlock (invalid schedule)"
        return batch_done, float(max(free))

    # ------------------------------ run ---------------------------------

    def run(self, fail: Optional[tuple[int, int]] = None) -> SimResult:
        """fail = (worker_index, batch_index): that worker dies right when
        `batch_index` starts (paper kills worker 1 at batch 205)."""
        cfg, proto = self.cfg, self.proto
        worker_ids = list(range(len(cfg.devices)))
        est = CapacityEstimator(cfg.profile.exec_times, len(worker_ids))
        L = cfg.profile.num_layers

        if cfg.policy == "ftpipehd":
            part = uniform_partition(L, len(worker_ids))
        elif cfg.policy in ("pipedream", "respipe"):
            # PipeDream DP under homogeneous assumption, static thereafter
            bws = np.array([cfg.bandwidth[i, i + 1]
                            for i in range(len(worker_ids) - 1)])
            part = solve_partition(cfg.profile.exec_times,
                                   cfg.profile.out_bytes,
                                   np.ones(len(worker_ids)), bws,
                                   cfg.comm_factor)
        else:
            raise ValueError(cfg.policy)

        events: list[tuple[float, str]] = []
        partitions = [(0, part.points)]
        batch_done = np.full(cfg.num_batches, np.nan)
        recovery_overhead = 0.0
        t = 0.0
        b0 = 0

        extra = set()
        if fail is not None:
            extra.add(fail[1])
        for d in cfg.devices:                          # capacity drift points
            for b, _ in d.capacity_schedule:
                extra.add(b)
        points = proto.control_points(cfg.num_batches,
                                      dynamic=(cfg.policy == "ftpipehd"),
                                      extra=sorted(extra))
        points = points + [cfg.num_batches]
        failed_done = False

        for nxt in points:
            if nxt <= b0:
                continue
            n_seg = nxt - b0
            seg_done, t_end = self._segment(part, worker_ids, n_seg, t)
            batch_done[b0:b0 + n_seg] = seg_done
            t = t_end
            b0 = nxt
            if b0 >= cfg.num_batches:
                break

            # measured times available after the first segment; Eq. 1 is a
            # RATIO against the central node, so a drifting central (its
            # capacity_schedule) rescales everyone else's estimate
            self._batch_now = b0
            central_cap = self._caps_now()[worker_ids[0]]
            for i, w in enumerate(worker_ids):
                a, e = part.ranges[i]
                meas = float(np.sum(cfg.profile.exec_times[a:e + 1])
                             * self._caps_now()[w] / max(central_cap, 1e-12))
                est.update(i, meas, a, e)

            # ---- failure event -----------------------------------------
            if fail is not None and b0 == fail[1] and not failed_done:
                failed_done = True
                fw = fail[0]
                pause = proto.detect_timeout + proto.probe_rtt
                if cfg.policy == "respipe":
                    # successor absorbs the failed stage's layers; replica is
                    # already in place -> no weight transfer
                    worker_ids = rd.update_worker_list(worker_ids, [fw])
                    est = est.drop_workers([fw])
                    new_part = protocol.respipe_takeover(part, fw)
                    recovery_overhead = pause - proto.detect_timeout \
                        - proto.probe_rtt
                else:
                    dec = protocol.plan_failure_recovery(
                        part, worker_ids, [fw], est, cfg.profile,
                        cfg.bandwidth, cfg.comm_factor)
                    worker_ids, new_part, est = (dec.worker_ids,
                                                 dec.partition, dec.est)
                    pause += protocol.redistribution_cost(
                        cfg.profile, cfg.bandwidth, worker_ids, dec.plans,
                        proto.commit_rtt)
                    recovery_overhead = pause
                events.append((t, f"failure w{fw}; recovery {pause:.3f}s "
                                  f"policy={cfg.policy}"))
                t += pause
                part = new_part
                partitions.append((b0, part.points))
                continue

            # ---- replication -------------------------------------------
            do_chain, do_global = proto.replication_due(b0)
            if do_chain or do_global:
                cc = (protocol.chain_cost(cfg.profile, cfg.bandwidth,
                                          part, worker_ids)
                      if do_chain else 0.0)
                gc = (protocol.global_cost(cfg.profile, cfg.bandwidth,
                                           part, worker_ids)
                      if do_global else 0.0)
                # same decision point live consults: overlapped rounds only
                # hold the drain for the snapshot+ack round trip — the
                # bytes ride the next segment's compute
                c = proto.replication_blocking_cost(cc, gc)
                mode = proto.replication_mode()
                kind = ("chain+global" if do_chain and do_global
                        else "chain" if do_chain else "global")
                suffix = " (overlapped)" if mode == "overlap" else ""
                events.append((t, f"{kind} replication {c:.3f}s{suffix}"))
                t += c

            # ---- dynamic re-partition ----------------------------------
            if cfg.policy == "ftpipehd" and proto.repartition_due(b0):
                new_part = protocol.solve_from_estimates(
                    cfg.profile, cfg.bandwidth, worker_ids, est,
                    cfg.comm_factor)
                # same adoption rule as the live runtime (lock-step): the
                # paper's points-changed test unless refit_hysteresis gates
                if protocol.refit_worthwhile(cfg.profile, cfg.bandwidth,
                                             worker_ids, est, part,
                                             new_part, proto):
                    plans = protocol.plan_repartition_all(new_part, part,
                                                          len(worker_ids))
                    c = protocol.redistribution_cost(cfg.profile,
                                                     cfg.bandwidth,
                                                     worker_ids, plans,
                                                     proto.commit_rtt)
                    events.append((t, f"re-partition {part.counts} -> "
                                      f"{new_part.counts} ({c:.3f}s)"))
                    t += c
                    part = new_part
                    partitions.append((b0, part.points))

        deltas = np.diff(np.concatenate([[0.0], batch_done]))
        return SimResult(batch_done=batch_done, batch_times=deltas,
                        total_time=float(batch_done[-1]), events=events,
                        partitions=partitions,
                        recovery_overhead=recovery_overhead)


def single_device_time(profile: WorkloadProfile, capacity: float,
                       num_batches: int) -> float:
    return float(np.sum(profile.exec_times) * capacity * num_batches)
