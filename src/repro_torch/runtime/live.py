"""Live multi-worker FTPipeHD runtime: real PyTorch training over message
passing, with the paper's full fault-tolerance protocol in the loop. The
port of ``src/repro/runtime/live.py``: the control plane is the same; the
data plane computes with torch on ``LiveConfig.device`` (CUDA unless the
caller passes ``"cpu"``).

A ``Coordinator`` (the paper's central node) drives N ``Worker``s over a
transport — in-process queues (``runtime/transport.py``: injectable
drop/delay/kill faults, optional wire codec) with workers as threads, or
length-prefixed TCP sockets (``runtime/net.py``) with workers as separate
OS processes, where fault injection SIGKILLs a real process
(``Coordinator(remote_devs=...)``). Each worker owns a contiguous slice of a
``runtime/workload.py`` layer chain, held as ONE packed flat f32 buffer
(``runtime/stage_executor.py``), and executes REAL per-stage training
through ``StageExecutor.step`` (forward recompute, autograd backward,
``kernels/fused_sgd`` CUDA kernel update) under the async
1F1B schedule from ``core/schedule.py``, with vertical-sync weight versions
retained per the in-flight rule (``VerticalSyncStash``; retention bounded
by n+1, concurrent training versions by ``schedule.stash_depth``). Weights
travel the transport as per-layer slices of the packed buffer, keyed by
layer id — the currency of replication, fetches, and the wire codec.

Control flow is shared with the timing simulator through
``runtime/protocol.py`` — one source of truth for replication cadence
(into ``checkpoint/replication_store.LayerReplicaStore`` + per-neighbor
chain replicas, §III-E), dynamic re-partition (§III-D: capacities measured
via ``core/capacity.py``, DP from ``core/partition.py``, fetches from
``core/redistribution.py`` plans), and failure handling (§III-F:
heartbeat timeout -> probe -> classify via ``core/fault.py`` -> renumber ->
recovery partition -> weight redistribution -> reset ids -> resume). The
simulator (``runtime/simulator.py``) predicts this runtime's decisions on a
virtual clock; both drain the pipeline at the same
``ProtocolConfig.control_points`` (the batch-boundary approximation the
simulator documents is this runtime's actual execution strategy).

In-process notes: workers are threads sharing one CUDA device and one
stream (each thread's current stream is the device's default stream), so
"devices" here exercise the PROTOCOL (heterogeneity enters via measured or
spec capacities, optionally emulated with sleeps), not real edge silicon.
Sharing the stream keeps hand-offs simple: a tensor a worker sends was
synchronised before the send, and the caching allocator never sees a
block used on another stream. The cost is that a worker's measured busy
time includes its neighbours' kernels, so measured capacities mean little
on one card; ``capacity_source="spec"`` gives deterministic partitions.
Every clock read that times device work is preceded by a stream sync.
Both endpoints of the data plane read batches from a shared ``data_fn``;
only activations/gradients/weights travel the transport.
"""
from __future__ import annotations

import dataclasses
import os
import threading
import time
from typing import Any, Callable, Optional

import numpy as np
import torch

from repro_torch.checkpoint.manifest import RunManifest
from repro_torch.checkpoint.replication_store import (
    DurableLayerReplicaStore, LayerReplicaStore)
from repro_torch.core import fault as fault_sm
from repro_torch.runtime import codec as wire_codec_mod
from repro_torch.core import schedule as sched
from repro_torch.core.capacity import CapacityEstimator
from repro_torch.core.partition import PartitionResult, uniform_partition
from repro_torch.core.redistribution import RedistributionPlan
from repro_torch.runtime import netem as netem_mod
from repro_torch.runtime import protocol
from repro_torch.runtime.devices import (DeviceSpec, WorkloadProfile,
                                        resolve_device, uniform_bandwidth)
from repro_torch.runtime.qtensor import host_array
from repro_torch.runtime.stage_executor import (ChainLayout, StageExecutor,
                                                aggregate_packed, warm_up)
from repro_torch.runtime.transport import (FaultSpec, Heartbeat, Transport,
                                           TransportBase)
from repro_torch.runtime.workload import LayerChain, synchronize

COORD = -1          # coordinator control-plane node id on the transport


class ChainCollapsedError(RuntimeError):
    """A §III-F recovery would leave the chain below
    ``LiveConfig.min_workers``: the chain fails FAST as a unit instead of
    limping on as a straggler replica. Fleet runs (``runtime/fleet.py``)
    catch this, degrade the fleet to the surviving chains, and re-admit a
    relaunched chain at a later aggregation round; a single-chain run sees
    it as a fatal error."""

    def __init__(self, chain_id: int, survivors, dead):
        super().__init__(
            f"chain {chain_id} collapsed: survivors {sorted(survivors)} "
            f"fell below the min_workers floor (dead: {sorted(dead)})")
        self.chain_id = chain_id
        self.survivors = sorted(survivors)
        self.dead = sorted(dead)
        self.worker_exitcodes: dict = {}     # filled by net.run_tcp_training
        self.exitcode_history: dict = {}


# ========================== vertical-sync stash ==========================

class VerticalSyncStash:
    """Per-stage weight-version ring honoring vertical sync (§III-C).

    Unlike ``core/stash.VersionedWeights`` (prune-oldest), retention here
    follows ``core/schedule.py``'s vertical-sync rule: batch b runs on
    version ``version_for_batch(b, n)`` at EVERY stage, so a version must
    survive from its creation (this stage's backward of batch v-1) until
    the forward of batch v+n-1 pins it — the versions still needed are the
    *oldest* recent ones, not the newest, which is why prune-oldest is
    wrong here. The retained-version high water is stage+2, bounded by
    n+1 — the same bound as the depth-(n+1) ring in
    ``runtime/semantics.AsyncTrainingExecutor``; the paper's n-i figure
    (``schedule.stash_depth``) counts concurrently TRAINING versions
    (distinct versions among in-flight batches), which this stash also
    respects (see tests/test_live_runtime.py).

    The stashed value is opaque to the ring — the live runtime stores each
    version as one packed flat f32 buffer (``runtime/stage_executor``), so
    a version snapshot is a single array reference, not a pytree copy.
    """

    def __init__(self, slice_params: Any, version: int = 0):
        self.versions: dict[int, Any] = {version: slice_params}
        self.newest_v = version
        self.high_water = 1

    def newest(self) -> Any:
        return self.versions[self.newest_v]

    def get(self, version: int) -> Any:
        """Exact, else nearest OLDER (PipeDream: never a newer one), else
        the oldest available (post-drain resume semantics)."""
        if version in self.versions:
            return self.versions[version]
        older = [v for v in self.versions if v <= version]
        if older:
            return self.versions[max(older)]
        return self.versions[min(self.versions)]

    def push(self, version: int, slice_params: Any) -> None:
        self.versions[version] = slice_params
        self.newest_v = max(self.newest_v, version)
        self.high_water = max(self.high_water, len(self.versions))

    def prune(self, min_needed: float) -> None:
        """Drop versions no future forward can pin (always keep newest)."""
        for v in [v for v in self.versions
                  if v < min_needed and v != self.newest_v]:
            del self.versions[v]

    def reset(self, slice_params: dict, version: int) -> None:
        self.versions = {version: slice_params}
        self.newest_v = version


# ================================ config =================================

@dataclasses.dataclass
class LiveConfig:
    num_workers: int = 3
    num_batches: int = 30
    protocol: protocol.ProtocolConfig = dataclasses.field(
        default_factory=lambda: protocol.ProtocolConfig(detect_timeout=0.5))
    lr: float = 0.05
    momentum: float = 0.0
    weight_decay: float = 0.0
    aggregate_every: int = 0              # 0 = off (per-stage aggregation)
    device_specs: Optional[list[DeviceSpec]] = None
    bandwidth: Optional[np.ndarray] = None   # for the partition DP only
    profile: Optional[WorkloadProfile] = None  # else measured at startup
    capacity_source: str = "measured"     # "measured" | "spec"
    emulate_capacity: bool = False        # sleep-scale slow devices
    heartbeat_interval: float = 0.05
    poll: float = 0.01
    kill: Optional[tuple[int, int]] = None   # (device, batch): crash when
    #                                          that batch commits at stage 0
    fault: Optional[FaultSpec] = None
    segment_timeout: float = 120.0
    profile_repeats: int = 2
    compiled: bool = True        # fused StageExecutor hot path (CUDA kernel
    #                              update); False keeps the per-layer
    #                              autograd + sgd_update reference
    wire_codec: bool = False     # round-trip every payload through codec.py
    # ---- wire compression (codec.WirePolicy tiers) ----------------------
    wire_compress: str = "off"   # data-plane tier for act/grad payloads:
    #                              "off" | "fp16" | "int8" (per-tensor
    #                              affine, codec-side numpy) |
    #                              "int8-fused" (per-channel affine
    #                              quantized on the device by the
    #                              kernels/quant CUDA kernels, with
    #                              error-feedback residuals; the codec
    #                              ships the payload zero-copy). Any tier
    #                              != "off" implies the wire codec. Decode
    #                              is self-describing; the §III-F
    #                              redistribution payloads stay exact f32
    #                              regardless of tier.
    wire_compress_replica: Optional[str] = None   # §III-E replica tier
    #                              (chain_put/global_put); None = follow
    #                              wire_compress ("int8-fused" downgrades
    #                              to tag-12 int8 there: replica payloads
    #                              are plain snapshots, not stage outputs)
    device: Optional[str] = None   # torch device of the data plane: None
    #                                = "cuda" (raises without a GPU); pass
    #                                "cpu" to run on the CPU
    # ---- elastic membership (rejoin / hot-join) -------------------------
    rejoin: Optional[tuple[int, int]] = None   # (device, batch): relaunch
    #   the previously-killed device when that batch commits; it rejoins
    #   with a bumped incarnation and the pipeline expands back
    join_after: Optional[int] = None   # batch: hot-join a NEVER-seen device
    #   (id = num_workers) when that batch commits, growing the pipeline
    #   beyond the launch set
    join_wait: float = 20.0      # max seconds the coordinator waits at a
    #   control point for a scheduled joiner's hello before giving up on
    #   admitting it there (bounded — a no-show can never wedge the run)
    # ---- reliable data plane (seq/ack retransmit window) ----------------
    reliable_data: bool = False  # retransmit unacked act/grad frames at
    #   the transport layer (TransportBase seq/ack window) instead of
    #   paying a segment-timeout drain per dropped frame. Cluster-wide:
    #   every node's transport must agree (the facade/CLI set it on all)
    rto: float = 0.25            # retransmit timeout (seconds) when
    #   reliable_data is on
    # ---- durable control plane (disk replicas + run manifest) -----------
    run_dir: Optional[str] = None   # directory for the disk replica tier
    #   and the run manifest; None = pure in-memory coordinator (legacy)
    start_batch: int = 0         # first batch of this process's training
    #   loop: 0 for a fresh run, manifest last_committed + ... on resume
    resume: bool = False         # this coordinator is a RELAUNCH: seed
    #   worker slices from the disk-backed global store, tolerate absent
    #   workers at bring-up, and re-adopt live remote workers through the
    #   abort+install handshake instead of assuming a cold cluster
    # ---- WAN emulation + estimator robustness ---------------------------
    netem: Optional["netem_mod.NetemSpec"] = None   # per-link shaping
    #   (latency/jitter, token-bucket bandwidth, loss, timed partitions)
    #   layered under the transport; None = unshaped. Rides the config to
    #   every node so queue and TCP runs shape identically
    capacity_ema: float = 0.0    # EWMA factor for capacity samples
    #   (CapacityEstimator ema): 0 = paper's last-sample-wins, 0.6-0.8
    #   smooths jittery WAN measurements
    static_partition: bool = False   # PipeDream static baseline: equal
    #   split at launch AND at every re-solve (recovery still re-splits
    #   over the survivor count) — the control arm the WAN heterogeneity
    #   bench compares the paper's dynamic partition against
    # ---- fleet membership (data-parallel chains) ------------------------
    min_workers: int = 1         # §III-F floor: a recovery that would leave
    #   fewer live workers raises ChainCollapsedError instead of re-solving
    #   — fleet chains fail fast as a unit (the fleet degrades to M-1 and
    #   re-admits a fresh chain later) rather than limping as stragglers
    kill_all_at: Optional[int] = None   # fault injection: kill EVERY
    #   non-central worker when this batch commits — the whole-chain fault
    #   of the fleet demo (works on both transports; over TCP each worker
    #   process SIGKILLs itself)
    collect_final: bool = False  # force a final global replication at the
    #   end of the batch loop and snapshot the per-layer packed weights
    #   into LiveResult.final_flats (fleet chains and the aggregation
    #   bench need the finished model; off by default — one extra
    #   replication round is not free)
    # ---- overlap-everything scheduler (ROADMAP direction 5) -------------
    overlap_replication: bool = False   # §III-E replication (and §III-D
    #   admission capacity probes) leave the control point as a snapshot
    #   + immediate ack; the replica bytes ship DURING the next segment's
    #   compute instead of inside the drain. Seeding rounds (batch 0,
    #   post-admission re-seed) and barrier rounds (fleet sync, final
    #   collect) always drain. Off = drain mode, the control arm the WAN
    #   bench compares against (docs/protocol.md §10)
    repl_delta: str = "counters"        # §III-E delta-skip detector:
    #   "counters" consults the StageExecutor's O(1) per-layer change
    #   counters (a layer whose counter matches the last ship is skipped
    #   without touching its bytes); "bytes" keeps the legacy per-layer
    #   byte compare against a shadow copy (exact, but O(bytes) per layer
    #   per peer at every control point)

    def wire_policy(self) -> wire_codec_mod.WirePolicy:
        """The compression tiers this config asks for, as the per-kind
        policy both transports consult at encode time."""
        replica = (self.wire_compress if self.wire_compress_replica is None
                   else self.wire_compress_replica)
        return wire_codec_mod.WirePolicy(data=self.wire_compress,
                                         replica=replica)


@dataclasses.dataclass
class LiveResult:
    losses: np.ndarray                     # [B] final loss per batch index
    loss_log: list                         # chronological (batch, loss)
    partitions: list                       # [(from_batch, points)]
    events: list                           # [(t_wall, str)]
    capacities: np.ndarray                 # final estimator view
    transport_stats: dict
    stash_high_water: dict                 # device -> max live versions
    recoveries: list                       # [{failed, restart, partition}]
    commit_times: dict = dataclasses.field(default_factory=dict)
    #   batch -> seconds since the coordinator's clock zero at which that
    #   batch's commit was (last) absorbed — per-batch wall timing for
    #   benchmarks (diff consecutive batches for steady-state batch time)
    worker_exitcodes: dict = dataclasses.field(default_factory=dict)
    #   dev -> OS exit code, filled by net.run_tcp_training (multi-process
    #   runs only; a SIGKILLed worker reports -9)
    admissions: list = dataclasses.field(default_factory=list)
    #   [{devs, incs, batch, partition}] — one record per elastic
    #   admission (worker rejoin or hot-join)
    exitcode_history: dict = dataclasses.field(default_factory=dict)
    #   dev -> [exit codes in incarnation order] (multi-process runs; a
    #   SIGKILL-then-rejoin device reads [-9, 0])
    replica_report: dict = dataclasses.field(default_factory=dict)
    #   LayerReplicaStore.nbytes_report() of the coordinator's global
    #   store at teardown (includes the on-disk tier for durable runs)
    final_flats: Optional[dict] = None
    #   {layer -> packed flat f32 weights} of the finished model, snapshot
    #   from the global store after a forced end-of-run replication —
    #   only populated under ``LiveConfig.collect_final``
    shipped_gens: dict = dataclasses.field(default_factory=dict)
    #   dev -> newest replication generation (batch stamp) that device
    #   reported FULLY shipped (its overlap queue drained) — the
    #   coordinator's in-flight-replication bookkeeping, piggybacked on
    #   seg_done; empty in drain mode
    startup_s: Optional[float] = None
    #   seconds from spawning the worker processes to the coordinator
    #   hearing from the last of them (net.run_tcp_training only)

    @property
    def final_partition(self) -> tuple:
        return self.partitions[-1][1]


# ================================ worker =================================

class Worker(threading.Thread):
    """One pipeline stage executor on one 'device' (thread)."""

    def __init__(self, dev: int, chain: LayerChain, data_fn, transport,
                 cfg: LiveConfig, abort_event: threading.Event,
                 spec: DeviceSpec, layout: ChainLayout, global_store=None,
                 remote: bool = False, incarnation: int = 0,
                 announce: bool = False,
                 hello_payload: Optional[dict] = None):
        super().__init__(daemon=True, name=f"worker-{dev}")
        self.dev = dev
        self.chain = chain
        self.data_fn = data_fn
        self.transport = transport
        self.cfg = cfg
        self.abort_event = abort_event
        self.spec = spec
        self.layout = layout                   # shared packed-buffer layout
        self.device = resolve_device(cfg.device)
        self.global_store = global_store       # central worker only
        self.remote = remote                   # own-process worker (net.py):
        #                                        abort arrives as a message,
        #                                        "die" means SIGKILL yourself
        self.incarnation = incarnation         # bumped per relaunch; a die
        #                                        naming an older incarnation
        #                                        is a stale frame — ignored
        self.announce = announce               # hello the coordinator at
        #                                        loop start, and RESEND it
        #                                        until any inbound message
        #                                        proves we are known (a
        #                                        single hello lost to a
        #                                        drop fault or an expired
        #                                        retry window must not
        #                                        silently cancel a join)
        self.hello_payload = (hello_payload
                              or {"dev": dev, "inc": incarnation})
        self.stop_event = threading.Event()
        self.hb = Heartbeat(transport, dev, COORD, cfg.heartbeat_interval)
        self.stash: Optional[VerticalSyncStash] = None
        self.slice_layout = None               # SliceLayout of layer_range
        self.mom_buf = None                    # packed momentum, slice-sized
        self.replicas = LayerReplicaStore()    # neighbor copies, tier "chain"
        self.backwards_done = 0
        self._seg_id = -1
        self._req_seq = 0        # monotonic: stale fetch_res never matches
        self._refit_cancel = False   # coordinator abandoned the refit in
        #                              flight (a holder died): do NOT
        #                              install, keep the pre-refit state
        self._installed_key = None   # (range, version) of the last applied
        #                              install MESSAGE: a relaunched
        #                              coordinator resends installs until
        #                              acked, and a duplicate must re-ack
        #                              without resetting the stash
        self._execs: dict[tuple, StageExecutor] = {}
        # §III-E delta-plus-skip: per-peer shadow of the packed layer
        # slices last shipped there, keyed by (tier, peer node) — unchanged
        # layers are named instead of resent (see _delta_layers). In
        # counters mode the shadow holds (batch, change-counter) pairs
        # instead of byte copies.
        self._repl_shadow: dict[tuple, dict[int, np.ndarray]] = {}
        self._gen_shadow: dict[tuple, dict[int, tuple[int, int]]] = {}
        # overlap scheduler: replica shipments deferred past the control
        # point — (dest, kind, payload, commit) tuples drained one per op
        # during the next segment's compute (and in idle loop gaps). The
        # payload arrays are snapshots taken at the control point, so
        # training ahead of the queue cannot tear them.
        self._pending_ship: list[tuple] = []
        self._ship_gen = -1       # generation of the queued shipments
        self._shipped_gen = -1    # newest generation fully on the wire
        # change-counter bumps for writes that bypass the fused step
        # (aggregation's stash push); added on top of the executors'
        # per-step counters by _gen_of
        self._extra_gen = 0
        self._acts: dict[int, Any] = {}
        self._grads: dict[int, Any] = {}
        # acts/grads that arrived for a segment we have not ENTERED yet:
        # links are independently delayed (WAN jitter, netem), so a peer's
        # first act of segment N can beat the coordinator's own `segment`
        # N message here — buffer by (seg_id, kind, batch) and claim them
        # at segment entry instead of dropping (which wedges the pipeline
        # until segment_timeout)
        self._future: dict[tuple[int, str, int], Any] = {}
        self._fwd_ctx: dict[int, tuple] = {}   # batch -> (version buf, x)
        # error-feedback residuals for the int8-fused wire tier (AccEPT):
        # one per boundary direction, carried across batches by
        # StageExecutor.forward_q/step_q like momentum; reset whenever the
        # slice changes (activation shapes may change with it)
        self._act_res = None
        self._grad_res = None
        self._fetch_res: dict[int, dict] = {}
        # pre-refit snapshot: peers' redistribution plans reference the OLD
        # partition, so fetches must be served from it even after this
        # worker has already committed its own new slice
        self._pre_refit: dict[int, Any] = {}

    # ----------------------------- lifecycle -----------------------------

    def install(self, layer_range: tuple[int, int], flats: dict,
                version: int = 0) -> None:
        """Install a layer slice (startup or redistribution commit).

        ``flats`` maps each layer in range to its packed flat f32 weights
        (the wire/replica currency). Momentum is preserved per layer across
        re-partitions; layers new to this worker start at zero."""
        a, e = layer_range
        old_mom: dict[int, Any] = {}
        if self.slice_layout is not None and self.mom_buf is not None:
            old_mom = {j: self.slice_layout.view(self.mom_buf, j)
                       for j in self.slice_layout.layer_ids}
        self.layer_range = (a, e)
        self.slice_layout = self.layout.slice(a, e)
        buf = self.slice_layout.pack(flats)
        self.mom_buf = self.slice_layout.pack(
            {j: old_mom.get(j, np.zeros(self.layout.layer_size(j),
                                        np.float32))
             for j in range(a, e + 1)})
        if self.stash is None:
            self.stash = VerticalSyncStash(buf, version)
        else:
            self.stash.reset(buf, version)
        # the slice (and possibly the membership around it) changed: every
        # delta-skip shadow is stale — the next replication resends in full
        self._repl_shadow.clear()
        self._gen_shadow.clear()
        # overlap: un-shipped replica snapshots predate this install's
        # topology (their chain_to / store routing is from the old epoch) —
        # drop them. Receivers simply keep their last COMPLETE generation;
        # the coordinator re-seeds in full after every recovery/admission.
        self._pending_ship.clear()
        self._extra_gen += 1       # installed weights differ from any shadow
        # boundary shapes may have changed with the slice; quantization
        # error carried against the old boundary is meaningless now
        self._act_res = None
        self._grad_res = None

    def _executor(self, last: bool) -> StageExecutor:
        """Per (slice, role) compiled executor; rebuilt only on refit."""
        key = (self.layer_range, last)
        if key not in self._execs:
            self._execs[key] = StageExecutor(
                self.chain, self.slice_layout, last=last, lr=self.cfg.lr,
                momentum=self.cfg.momentum,
                weight_decay=self.cfg.weight_decay,
                compiled=self.cfg.compiled, device=self.device)
        return self._execs[key]

    def crash(self) -> None:
        """Simulated device death: stops compute AND connectivity."""
        self.stop_event.set()
        self.hb.stop()
        self.transport.kill(self.dev)

    def _die(self) -> None:
        """Injected fatal fault. A remote (own-process) worker SIGKILLs its
        process — no cleanup, sockets break mid-stream, heartbeats stop —
        which is the real §III-F trigger. An in-process worker falls back
        to the simulated crash."""
        if self.remote:
            import os
            import signal
            os.kill(os.getpid(), signal.SIGKILL)
        self.crash()

    def _maybe_die(self, payload) -> None:
        """Epoch-fenced ``die``: fault injection names the incarnation it
        was aimed at. A relaunched worker (higher incarnation) reusing the
        dead one's port could otherwise be killed by a stale frame still
        in a sender's retry queue."""
        inc = payload.get("inc") if isinstance(payload, dict) else None
        if inc is not None and inc != self.incarnation:
            return
        self._die()

    def shutdown(self) -> None:
        """Cooperative stop (end of run): cease the loop and the beacon."""
        self.stop_event.set()
        self.hb.stop()

    # ------------------------------- main --------------------------------

    def run(self):
        """Message loop: react to coordinator commands and peer traffic
        until a ``stop`` (clean shutdown) or ``die`` (injected crash)."""
        greeted = not self.announce
        last_hello = 0.0
        self.hb.start()
        while not self.stop_event.is_set():
            if not greeted:
                # announce (and re-announce) the incarnation: hello is the
                # one message that crosses the kill-fence, and until we
                # are admitted it is our only voice — resend until ANY
                # inbound message proves the coordinator unfenced us
                now = time.monotonic()
                if now - last_hello > max(0.5, self.cfg.heartbeat_interval):
                    self.transport.send(self.dev, COORD, "hello",
                                        self.hello_payload)
                    last_hello = now
            msg = self.transport.recv(self.dev, timeout=self.cfg.poll)
            if msg is None:
                # idle gap between segments: drain any replica shipments
                # the overlap scheduler deferred past the control point
                self._ship_pending()
                continue
            greeted = True
            k = msg.kind
            if k == "segment":
                self._run_segment(msg.payload)
            elif k in ("act", "grad"):
                # a peer's data for the NEXT segment outran our `segment`
                # message (independent link delays); _dispatch buffers it
                self._dispatch(msg)
            elif k == "replicate":
                self._do_replicate(msg.payload)
            elif k in ("repart", "recover"):
                self._do_refit(msg.payload)
            elif k == "install":
                self._do_install(msg.payload)
            elif k == "fetch_req":
                self._serve_fetch(msg)
            elif k in ("chain_put", "ov_chain_put"):
                self._store_chain(msg.payload)
            elif k == "probe":
                self.transport.send(self.dev, COORD, "probe_ack",
                                    {"status": "ok"})
            elif k == "cap_probe":
                self._do_cap_probe(msg.payload)
            elif k == "admit":
                # admission confirmed; adopt the coordinator's wire policy
                # (the repart that follows carries the slice assignment)
                self._apply_wire(msg.payload)
            elif k == "abort":
                self.abort_event.set()
            elif k == "refit_abort":
                self._refit_cancel = True
            elif k == "die":
                self._maybe_die(msg.payload)
            elif k == "stop":
                break
        self.hb.stop()

    # --------------------------- segment exec ----------------------------

    def _dispatch(self, msg):
        """Route a message that arrived while waiting on a dependency."""
        k = msg.kind
        if k in ("act", "grad"):
            seg_id, b, x = msg.payload
            if seg_id == self._seg_id:          # stale segments are dropped
                (self._acts if k == "act" else self._grads)[b] = x
            elif seg_id > self._seg_id:         # early: segment msg in flight
                self._future[(seg_id, k, b)] = x
        elif k == "probe":
            self.transport.send(self.dev, COORD, "probe_ack",
                                {"status": "ok"})
        elif k in ("chain_put", "ov_chain_put"):
            self._store_chain(msg.payload)
        elif k == "fetch_req":
            self._serve_fetch(msg)
        elif k == "fetch_res":
            self._fetch_res[msg.payload["req_id"]] = msg.payload["layers"]
        elif k == "cap_probe":
            self._do_cap_probe(msg.payload)
        elif k == "abort":
            self.abort_event.set()
        elif k == "refit_abort":
            self._refit_cancel = True
        elif k == "die":
            self._maybe_die(msg.payload)
        elif k == "stop":
            self.stop_event.set()

    def _await(self, store: dict, key: int):
        while key not in store:
            if self.stop_event.is_set() or self.abort_event.is_set():
                return None
            msg = self.transport.recv(self.dev, timeout=self.cfg.poll)
            if msg is not None:
                self._dispatch(msg)
        return store.pop(key)

    def _learn_routes(self, spec: dict) -> None:
        """Install coordinator-provided peer addresses (TCP runs): a device
        admitted after this worker's bring-up is absent from its startup
        ``addr_of``, and acts/grads/fetches to it would otherwise drop."""
        addrs = spec.get("addrs")
        if addrs:                # no-op on in-process transports (ABC default)
            for d, a in addrs.items():
                if int(d) != self.dev:
                    self.transport.add_route(int(d), (a[0], int(a[1])))

    def _run_segment(self, spec: dict):
        if self.remote:      # any past abort is over once new work arrives
            self.abort_event.clear()
        self._learn_routes(spec)
        stage, n = spec["stage"], spec["n"]
        b0, nb = spec["b0"], spec["nb"]
        devs = spec["stage_devs"]
        self._seg_id = spec["seg_id"]
        self._acts.clear()
        self._grads.clear()
        for (sid, kind, b) in list(self._future):
            x = self._future.pop((sid, kind, b))
            if sid == self._seg_id:             # arrived before we entered
                (self._acts if kind == "act" else self._grads)[b] = x
            elif sid > self._seg_id:
                self._future[(sid, kind, b)] = x   # still ahead of us
        self._fwd_ctx.clear()
        self._pre_refit = {}          # redistribution is over once we train
        last = stage == n - 1
        ex = self._executor(last)
        cap = self.spec.capacity if self.cfg.emulate_capacity else 1.0
        # int8-fused tier: boundary tensors leave the device already
        # quantized (StageExecutor.forward_q/step_q + error feedback) and
        # the codec ships them zero-copy as tag 13
        policy = getattr(self.transport, "policy", None)
        fused = (policy is not None
                 and policy.tier_for("act") == "int8-fused")

        ops = list(sched.stage_schedule(stage, n, nb))
        # for retention pruning: next fwd batch at-or-after each op index
        next_fwd = [None] * (len(ops) + 1)
        for idx in range(len(ops) - 1, -1, -1):
            next_fwd[idx] = (b0 + ops[idx].batch if ops[idx].kind == "fwd"
                             else next_fwd[idx + 1])

        batch_times: dict[int, float] = {}     # fwd+bwd wall time per batch
        busy, done_ops = 0.0, 0
        for idx, op in enumerate(ops):
            if self.stop_event.is_set() or self.abort_event.is_set():
                break
            # overlap scheduler: interleave ONE deferred replica shipment
            # per op, so the §III-E bytes ride this segment's compute
            # instead of a control-point drain
            self._ship_pending(limit=1)
            gb = b0 + op.batch
            if op.kind == "fwd":
                if stage == 0:
                    x = self.chain.input_of(self.data_fn(gb))
                else:
                    x = self._await(self._acts, op.batch)
                    if x is None:
                        break
                ver = sched.version_for_batch(gb, n)
                ver_buf = self.stash.get(ver)
                t0 = time.perf_counter()
                if last:
                    loss = ex.forward(ver_buf, x, self.data_fn(gb))
                    self.transport.send(self.dev, COORD, "loss",
                                        (gb, loss.item()))
                elif fused:
                    y, self._act_res = ex.forward_q(ver_buf, x,
                                                    self._act_res)
                    synchronize(self.device)
                else:
                    y = ex.forward(ver_buf, x)
                    synchronize(self.device)
                # the backward recomputes the forward from exactly this
                # (version buffer, input) pair — same residuals the old
                # vjp-closure path kept alive, without storing them
                self._fwd_ctx[op.batch] = (ver_buf, x)
                dt = time.perf_counter() - t0
                if cap > 1.0:
                    time.sleep(dt * (cap - 1.0))
                    dt *= cap
                busy += dt
                batch_times[op.batch] = batch_times.get(op.batch, 0.0) + dt
                if not last:
                    self.transport.send(self.dev, devs[stage + 1], "act",
                                        (self._seg_id, op.batch, y))
            else:
                if last:
                    ct = None
                else:
                    ct = self._await(self._grads, op.batch)
                    if ct is None:
                        break
                t0 = time.perf_counter()
                ver_buf, x = self._fwd_ctx.pop(op.batch)
                if fused and stage > 0:
                    # quantize the outgoing cotangent inside the same
                    # compiled call (stage 0 sends no grad — plain step)
                    g_x, new_buf, self.mom_buf, self._grad_res = ex.step_q(
                        ver_buf, self.stash.newest(), self.mom_buf, x, ct,
                        self.data_fn(gb) if last else None, self._grad_res)
                else:
                    g_x, new_buf, self.mom_buf = ex.step(
                        ver_buf, self.stash.newest(), self.mom_buf, x, ct,
                        self.data_fn(gb) if last else None)
                synchronize(self.device)
                self.stash.push(max(gb + 1, self.stash.newest_v + 1),
                                new_buf)
                self.backwards_done += 1
                dt = time.perf_counter() - t0
                if cap > 1.0:
                    time.sleep(dt * (cap - 1.0))
                    dt *= cap
                busy += dt
                batch_times[op.batch] = batch_times.get(op.batch, 0.0) + dt
                if (self.cfg.aggregate_every
                        and self.backwards_done % sched.aggregation_interval(
                            stage, n, self.cfg.aggregate_every) == 0):
                    # paper §III-C: average the live concurrent versions and
                    # bump the counter (the Fig. 2 ver-3 -> ver-4 jump) —
                    # the same packed-buffer mean the fleet barrier runs
                    mean = aggregate_packed(
                        [self.stash.versions[v]
                         for v in sorted(self.stash.versions)])
                    self.stash.push(self.stash.newest_v + 1, mean)
                    self._extra_gen += 1   # stash write outside the fused
                    #                        step: keep change counters honest
                if stage > 0:
                    self.transport.send(self.dev, devs[stage - 1], "grad",
                                        (self._seg_id, op.batch, g_x))
                else:
                    self.transport.send(self.dev, COORD, "commit", gb)
                # retention target: the next forward here, or — once this
                # segment has none left — the NEXT segment's first batch,
                # so vertical sync survives the control-point drain
                nf = next_fwd[idx + 1]
                self.stash.prune(sched.version_for_batch(
                    b0 + nb if nf is None else nf, n))
            done_ops += 1
        self.stash.prune(sched.version_for_batch(b0 + nb, n))
        # flush whatever overlap shipments the segment's ops did not cover:
        # the control point that follows may replicate again (superseding
        # these) or enter recovery — either way the queue must be empty by
        # seg_done so fault-path behavior is deterministic
        self._ship_pending()
        self.transport.send(self.dev, COORD, "seg_done",
                            {"stage": stage, "busy": busy, "nb": nb,
                             "batch_times": sorted(batch_times.values()),
                             "seg_id": self._seg_id,
                             "ops_done": done_ops, "aborted":
                             done_ops < len(ops),
                             "shipped_gen": self._shipped_gen,
                             "stash_high_water": self.stash.high_water})

    # --------------------------- control plane ---------------------------

    def _snapshot(self) -> dict:
        """Newest weights as {layer -> packed flat f32}: cheap slices of the
        packed buffer, keyed by layer offset — no pytree traversal."""
        newest = self.stash.newest()
        return {j: self.slice_layout.view(newest, j)
                for j in self.slice_layout.layer_ids}

    def _do_cap_probe(self, spec: dict):
        """Admission capacity probe: time an eager forward over the given
        layer range on this device's OWN chain copy (init weights — timing
        only), so the coordinator can form an Eq. 1 capacity estimate for
        a joiner before it has run a single segment. The reference is the
        central node's profiled forward time for the same range."""
        a, e = spec.get("range", (0, self.chain.num_layers - 1))
        reps = max(1, int(spec.get("repeats", 2)))
        x0 = self.chain.input_of(self.data_fn(0))
        ts = []
        for _ in range(reps):
            x = x0
            t0 = time.perf_counter()
            with torch.no_grad():
                for j in range(a, e + 1):
                    x = self.chain.apply_layer(j, self.chain.params[j], x)
            synchronize(self.device)
            ts.append(time.perf_counter() - t0)
        self.transport.send(self.dev, COORD, "cap_probe_ack",
                            {"dev": self.dev, "t": float(np.median(ts)),
                             "range": (a, e)})

    def _delta_layers(self, peer_key: tuple, snap: dict, batch: int,
                      full: bool):
        """§III-E delta-plus-skip: diff each layer's packed slice against
        the shadow of what was last shipped to this peer. Returns
        ``(changed, same, commit)`` — ship ``changed``; ``same`` maps each
        unchanged layer to the batch stamp this worker last shipped it
        under, and the receiver re-stamps a stored copy ONLY if its own
        stamp matches (compare-and-stamp): transports are best-effort, so
        an earlier put this shadow believes delivered may never have
        arrived — an unconditional re-stamp would dress the receiver's
        older bytes in a fresh batch id, while a mismatch merely leaves
        them conservatively old. ``commit()`` is called once the send was
        accepted. ``full`` discards the shadow first: the coordinator
        forces it whenever the peer may have lost its store (batch 0, and
        re-seeding after an elastic admission)."""
        if full:
            self._repl_shadow.pop(peer_key, None)
        shadow = self._repl_shadow.setdefault(peer_key, {})
        changed, same, pending = {}, {}, {}
        for j, arr in snap.items():
            a = host_array(arr)
            prev = shadow.get(j)
            if prev is not None and prev[1].shape == a.shape \
                    and np.array_equal(prev[1], a):
                same[j] = prev[0]
                pending[j] = (batch, prev[1])
            else:
                changed[j] = arr
                pending[j] = (batch, np.array(a, copy=True))

        def commit():
            shadow.update(pending)

        return changed, same, commit

    def _gen_of(self, j: int) -> int:
        """Monotonic change generation of layer ``j``'s packed weights:
        the executors' per-step counters plus the worker-level bumps for
        writes outside the fused step (aggregation, install). Counters
        from retired executors (old slices) only ever add a frozen base —
        monotonicity is all the delta-skip needs."""
        g = self._extra_gen
        for ex in self._execs.values():
            g += ex.change_counts.get(j, 0)
        return g

    def _delta_counters(self, peer_key: tuple, snap: dict, batch: int,
                        full: bool):
        """Counters-mode delta-skip (``LiveConfig.repl_delta``): same
        contract as ``_delta_layers`` but a layer is proven unchanged by
        its change counter matching the one shadowed at the last ship —
        O(1) per layer, no byte copy, no compare. Conservative in the
        safe direction: a step that happened to rewrite identical bytes
        still bumps the counter and re-ships."""
        if full:
            self._gen_shadow.pop(peer_key, None)
        shadow = self._gen_shadow.setdefault(peer_key, {})
        changed, same, pending = {}, {}, {}
        for j, arr in snap.items():
            gen = self._gen_of(j)
            prev = shadow.get(j)
            if prev is not None and prev[1] == gen:
                same[j] = prev[0]
            else:
                changed[j] = arr
            pending[j] = (batch, gen)

        def commit():
            shadow.update(pending)

        return changed, same, commit

    def _ship_pending(self, limit: Optional[int] = None) -> None:
        """Send up to ``limit`` (None = all) queued overlap shipments.
        Each shipment is ONE message per (tier, peer) — atomic on the
        wire, so a receiver only ever stores complete snapshot
        generations (torn-write rule, docs/protocol.md §10). A send
        refused by a dead peer is dropped WITHOUT committing its shadow:
        the next round re-ships those layers."""
        sent = 0
        while self._pending_ship:
            dest, kind, payload, commit = self._pending_ship.pop(0)
            if self.transport.send(self.dev, dest, kind, payload):
                commit()
            sent += 1
            if limit is not None and sent >= limit:
                break
        if not self._pending_ship:
            self._shipped_gen = max(self._shipped_gen, self._ship_gen)

    def _do_replicate(self, spec: dict):
        if self.stash is None:
            return            # admitted but not yet installed: nothing to
            #                   snapshot; the coordinator's short ack window
            #                   tolerates the missing ack
        # a previous overlapped round still queued (very tight cadence or
        # an aborted segment): flush it first — per-peer compare-and-stamp
        # chains assume ships arrive in commit order
        self._ship_pending()
        snap = self._snapshot()
        full = bool(spec.get("full"))
        overlap = bool(spec.get("overlap"))
        delta = (self._delta_counters if self.cfg.repl_delta == "counters"
                 else self._delta_layers)
        ships = []
        if spec["chain"]:
            changed, same, commit = delta(
                ("chain", spec["chain_to"]), snap, spec["batch"], full)
            ships.append((spec["chain_to"],
                          "ov_chain_put" if overlap else "chain_put",
                          {"batch": spec["batch"],
                           "layers": changed, "same": same}, commit))
        if spec["global"]:
            changed, same, commit = delta(
                ("global", COORD), snap, spec["batch"], full)
            ships.append((COORD,
                          "ov_global_put" if overlap else "global_put",
                          {"batch": spec["batch"],
                           "layers": changed, "same": same}, commit))
        if overlap:
            # the snapshot views are of stash buffers that nothing writes
            # in place (training, aggregation and install all push NEW
            # tensors) — queuing them is torn-write-safe without a copy.
            # Ack NOW: the control point's job was the snapshot, the bytes
            # ride the next segment (_run_segment / idle-loop _ship_pending)
            self._pending_ship.extend(ships)
            self._ship_gen = spec["batch"]
            if not ships:
                self._shipped_gen = max(self._shipped_gen, spec["batch"])
        else:
            for dest, kind, payload, commit in ships:
                if self.transport.send(self.dev, dest, kind, payload):
                    commit()
            self._ship_gen = spec["batch"]
            self._shipped_gen = max(self._shipped_gen, spec["batch"])
        self.transport.send(self.dev, COORD, "replicated",
                            {"stage": spec["stage"], "overlap": overlap,
                             "gen": spec["batch"]})

    def _store_chain(self, payload: dict):
        self.replicas.put_many(payload["batch"], payload["layers"],
                               tier=LayerReplicaStore.CHAIN)
        self.replicas.refresh(payload["batch"], payload.get("same", {}),
                              tier=LayerReplicaStore.CHAIN)

    def _serve_fetch(self, msg):
        layers_out = {}
        held = self._snapshot() if self.stash is not None else {}
        for j in msg.payload["layers"]:
            if j in self._pre_refit:
                layers_out[j] = self._pre_refit[j]
            elif j in held:
                layers_out[j] = held[j]
            elif self.replicas.has(j):
                layers_out[j] = self.replicas.get(j)[1]
            elif self.global_store is not None and self.global_store.has(j):
                layers_out[j] = self.global_store.get(j)[1]
        self.transport.send(self.dev, msg.src, "fetch_res",
                            {"req_id": msg.payload["req_id"],
                             "layers": layers_out})

    def _await_fetches(self, pending: dict, new_params: dict) -> None:
        """Wait for fetch_res replies (serving peers' requests meanwhile).

        The deadline is HALF the coordinator's ready-collection window: if
        a holder is dead, this worker must still get its (global-backstop)
        ``ready`` out before the coordinator gives up on it — equal
        timeouts would turn every stalled fetch into a coordinator-side
        shortfall. An ``abort`` (the coordinator starting failure
        handling) releases the wait immediately."""
        deadline = time.monotonic() + 0.5 * self.cfg.segment_timeout
        while pending and time.monotonic() < deadline:
            for rid in [r for r in pending if r in self._fetch_res]:
                got = self._fetch_res.pop(rid)
                for j in pending.pop(rid):
                    if j in got:
                        new_params[j] = got[j]
            if not pending:
                break
            if self._refit_cancel or self.stop_event.is_set() \
                    or self.abort_event.is_set():
                break
            msg = self.transport.recv(self.dev, timeout=self.cfg.poll)
            if msg is not None:
                self._dispatch(msg)

    def _apply_wire(self, spec) -> None:
        """Tier-negotiation commit: the coordinator's ``install``/``admit``
        carries its ``WirePolicy``, and this worker's transport adopts it —
        so a worker launched with mismatched ``--wire-compress`` flags
        converges on the coordinator's tiers. Decode needs no negotiation
        (tags are self-describing); only the ENCODE side is steered."""
        w = spec.get("wire") if isinstance(spec, dict) else None
        if w:
            self.transport.set_policy(wire_codec_mod.WirePolicy.from_payload(w))

    def _do_install(self, spec: dict):
        """Startup install for a remote worker: the coordinator ships the
        initial slice over the wire (range + per-layer packed weights);
        ACK with ``ready`` so the control plane can start segment 0.

        Idempotent per (range, version): a relaunched coordinator
        re-adopting this worker RESENDS the install until the ready ack
        gets through, and applying a duplicate would throw away live
        training state (stash reset) mid-run — so a repeat is re-acked
        without reinstalling (docs/protocol.md §8)."""
        self._apply_wire(spec)
        a, e = spec["range"]
        version = spec.get("version", 0)
        key = ((a, e), version)
        if self._installed_key != key:
            self._learn_routes(spec)
            # a fresh install fences a new data-plane era: drop reliable
            # seq/ack state so a relaunched peer's restarted sequence
            # space isn't mistaken for duplicates (docs/protocol.md §8)
            self.transport.reliable_reset()
            self.install((a, e),
                         {int(j): p for j, p in spec["layers"].items()},
                         version=version)
            self._installed_key = key
        self.transport.send(self.dev, COORD, "ready",
                            {"stage": spec.get("stage", -1), "missing": [],
                             "version": version})

    def _do_refit(self, spec: dict):
        """Re-partition / recovery commit: assemble the new slice from local
        weights + fetches per the redistribution plan, then ACK ready. A
        ``refit_abort`` received mid-fetch abandons the refit WITHOUT
        installing (the coordinator found a dead holder and will send a
        fresh ``recover``; completing from the stale global backstop here
        would swap in old weights)."""
        if self.remote:      # the drain this refit follows has completed
            self.abort_event.clear()
        self._learn_routes(spec)
        self._refit_cancel = False
        a, e = spec["range"]
        devs = spec["stage_devs"]
        # a JOINER (admission refit) holds no slice yet: nothing local to
        # serve, everything arrives by fetch
        held = self._snapshot() if self.stash is not None else {}
        # MERGE (not replace): back-to-back refits — an abandoned
        # re-partition followed by a §III-F recovery — leave peers (and
        # this worker's own plan) referencing slices from either layout;
        # the union keeps every layer serveable until training resumes
        # (_run_segment clears it)
        self._pre_refit = {**self._pre_refit, **held}
        self._fetch_res.clear()     # drop any stale replies from a past refit
        new_params: dict[int, Any] = {}
        for j in spec["local"]:
            if j in self._pre_refit:
                new_params[j] = self._pre_refit[j]
            # else: the plan thought we held j but a refit moved it away —
            # the missing/backstop path below fetches it instead
        pending: dict[int, list[int]] = {}
        for target, layers in spec["need"].items():
            dev_t = devs[target]
            if dev_t == self.dev:               # I hold the replica myself
                for j in layers:
                    if self.replicas.has(j):
                        new_params[j] = self.replicas.get(j)[1]
                    elif (self.global_store is not None
                          and self.global_store.has(j)):
                        new_params[j] = self.global_store.get(j)[1]
                continue
            self._req_seq += 1
            pending[self._req_seq] = list(layers)
            self.transport.send(self.dev, dev_t, "fetch_req",
                                {"req_id": self._req_seq,
                                 "layers": list(layers),
                                 "reply_to": self.dev})
        self._await_fetches(pending, new_params)
        if self._refit_cancel:
            return           # keep the pre-refit slice; a fresh refit follows
        missing = [j for j in range(a, e + 1) if j not in new_params]
        if missing:
            # §III-F backstop: a planned holder may be unable to serve —
            # e.g. a failure lands after a re-partition but before the next
            # chain cadence, so its replica still covers the OLD slice.
            # The central node's layer-keyed global store (full coverage
            # since the batch-0 snapshot) is the fallback of last resort.
            if self.global_store is not None:
                for j in list(missing):
                    if self.global_store.has(j):
                        new_params[j] = self.global_store.get(j)[1]
            elif devs[0] != self.dev:
                self._req_seq += 1
                self.transport.send(self.dev, devs[0], "fetch_req",
                                    {"req_id": self._req_seq,
                                     "layers": missing,
                                     "reply_to": self.dev})
                self._await_fetches({self._req_seq: missing}, new_params)
                if self._refit_cancel:
                    return       # same guard as above: never install a
                    #              backstop result the coordinator cancelled
            missing = [j for j in range(a, e + 1) if j not in new_params]
        if not missing:
            self.install((a, e), new_params, version=spec["version"])
        self.transport.send(self.dev, COORD, "ready",
                            {"stage": spec["stage"], "missing": missing,
                             "version": spec["version"]})


# ============================== coordinator ==============================

class Coordinator:
    """The central node (§III-A): owns the worker list, the fault timer,
    the capacity estimator, the partition DP, and the global replica store.
    The coordinator device (0) also runs stage 0 — it never fails.

    ``remote_devs`` lists worker devices that run in their OWN processes
    (``runtime/net.py``): no ``Worker`` thread is created for them, their
    initial slice is shipped as an ``install`` message, aborts reach them
    as ``abort`` messages, and fault injection sends ``die`` (the worker
    process SIGKILLs itself) instead of calling ``Worker.crash``."""

    def __init__(self, chain: LayerChain, data_fn: Callable[[int], dict],
                 cfg: LiveConfig, transport: Optional[TransportBase] = None,
                 remote_devs: Optional[set] = None,
                 spawner: Optional[Callable[[int, int], None]] = None,
                 manifest_doc: Optional[dict] = None,
                 resume_state: Optional[dict] = None,
                 aggregator=None, chain_id: int = 0,
                 init_flats: Optional[dict] = None):
        self.chain = chain
        self.data_fn = data_fn
        self.cfg = cfg
        self.device = resolve_device(cfg.device)
        if chain.device != self.device:
            raise ValueError(f"the chain lives on {chain.device} but "
                             f"LiveConfig.device is {self.device}")
        # LiveConfig.overlap_replication mirrors into the shared protocol
        # decision layer, so the simulator run with the same
        # ProtocolConfig predicts exactly the control points live executes
        self.proto = cfg.protocol
        if cfg.overlap_replication and not self.proto.overlap_replication:
            self.proto = dataclasses.replace(self.proto,
                                             overlap_replication=True)
        self.shipped_gens: dict[int, int] = {}   # dev -> newest FULLY
        #   shipped replication generation (from seg_done piggyback) —
        #   in-flight-replication bookkeeping for the overlap scheduler
        # ---- fleet membership (data axis, runtime/fleet.py) -------------
        self.aggregator = aggregator     # FleetAggregator barrier, or None
        self.chain_id = chain_id         # this chain's id within the fleet
        self.init_flats = init_flats     # {layer -> packed flat}: startup
        #   weights for a chain re-admitted mid-run (seeded from the last
        #   published fleet mean instead of init params)
        self.final_flats: Optional[dict] = None
        self._kill_all = cfg.kill_all_at
        N = cfg.num_workers
        self.specs = list(cfg.device_specs
                          or [DeviceSpec(f"dev-{i}") for i in range(N)])
        assert len(self.specs) == N
        self.bandwidth = (cfg.bandwidth if cfg.bandwidth is not None
                          else uniform_bandwidth(N))
        self.wire = cfg.wire_policy()
        self.transport = transport or Transport.create(
            "queue", fault=cfg.fault, codec=cfg.wire_codec,
            policy=self.wire, reliable=cfg.reliable_data, rto=cfg.rto,
            netem=cfg.netem)
        if transport is not None:
            # the coordinator's policy is authoritative for the cluster:
            # applied to its own endpoint here, shipped to remote workers
            # in the install/admit handshake
            transport.set_policy(self.wire)
        self.remote_devs = set(remote_devs or ())
        assert 0 not in self.remote_devs, \
            "worker 0 shares the coordinator process (the central node)"
        # ---- durable control plane (manifest + resume) ------------------
        self.run_dir = cfg.run_dir
        self._manifest_config = manifest_doc or {}
        rs = resume_state or {}
        ids = rs.get("worker_ids")
        # the worker set this coordinator brings up: a RELAUNCH adopts the
        # manifest's membership (which may differ from range(N) after
        # failures/joins); a fresh run starts with the launch set
        self._startup_ids = ([int(d) for d in ids] if ids
                             else list(range(N)))
        self.worker_view = list(self._startup_ids)   # current membership,
        #   mirrored from the batch loop for status()/kill_all targeting
        self.transport.register(COORD)
        for dev in set(range(N)) | set(self._startup_ids):
            self.transport.register(dev)
        self.layout = chain.flat_layout()
        if self.run_dir is not None:
            self.global_store: LayerReplicaStore = DurableLayerReplicaStore(
                os.path.join(self.run_dir, "replicas"))
        else:
            self.global_store = LayerReplicaStore()
        self.abort_event = threading.Event()
        self._stop_requested = threading.Event()
        for dev in self._startup_ids:
            self._ensure_spec(dev)       # manifest ids can exceed N (hot-join)
        self.workers = {
            dev: Worker(dev, chain, data_fn, self.transport, cfg,
                        self.abort_event, self.specs[dev], self.layout,
                        global_store=self.global_store if dev == 0 else None)
            for dev in self._startup_ids if dev not in self.remote_devs}
        self.events: list = []
        self.loss_log: list = []
        self.losses = np.full(cfg.num_batches, np.nan)
        self.recoveries: list = []
        self.stash_high_water: dict[int, int] = {}
        self._seg_counter = 0
        self._cur_seg = -1
        self._done: dict[int, dict] = {}
        self._committed = -1
        self.commit_times: dict[int, float] = {}
        self._last_hb: dict[int, float] = {}
        self._ready_acks: dict[int, set] = {}    # refit version -> acked devs
        self._ready_missing: dict[int, list] = {}
        self._t0 = time.monotonic()
        if cfg.kill is not None:
            assert cfg.kill[0] != 0, "the central node (device 0) never fails"
        self._kill = dict([cfg.kill]) if cfg.kill else {}
        # ---- elastic membership state -----------------------------------
        self.spawner = spawner           # harness hook: launch a new worker
        #                                  process (dev, incarnation); None
        #                                  = spawn an in-process thread
        self.admissions: list = []
        self._inc: dict[int, int] = {dev: 0 for dev in range(N)}
        #   admitted incarnation per device; a hello at or below it while
        #   the device is fenced is a stale frame and is ignored
        for d, inc in rs.get("incarnations", {}).items():
            # resume: restore PR 4 epoch fencing so a zombie of a fenced
            # incarnation cannot talk its way back in past the relaunch
            self._inc[int(d)] = int(inc)
        self._pending_joins: dict[int, dict] = {}   # dev -> {inc, addr}
        self._spawn_queue: dict[int, int] = {}      # dev -> incarnation,
        #   deferred until the dev has left the worker list (a rejoin
        #   scheduled before its death is even detected must not race
        #   §III-F fencing)
        self._join_deadline: dict[int, float] = {}  # dev -> give-up time
        self._cap_acks: dict[int, dict] = {}
        self._dev_addrs: dict[int, tuple] = {}      # dev -> (host, port)
        #   learned from hellos; shipped to peers with segment/refit
        #   payloads so workers can route to devices admitted after their
        #   own bring-up (TCP runs; empty under the queue transport)
        for node, a in rs.get("addr_of", {}).items():
            if int(node) > 0:            # resume: pre-learned worker routes
                self._dev_addrs[int(node)] = (a[0], int(a[1]))
        self._respawn: dict[int, int] = {}          # dev -> commit batch
        if cfg.rejoin is not None:
            dev, b = cfg.rejoin
            assert dev != 0, "the central node (device 0) cannot rejoin"
            self._respawn[dev] = b
        if cfg.join_after is not None:
            self._respawn[N] = cfg.join_after       # hot-join: next free id

    # ------------------------------ helpers ------------------------------

    def _log(self, text: str):
        self.events.append((time.monotonic() - self._t0, text))

    def membership(self) -> dict:
        """Live membership snapshot (nested ``Run.status()`` schema)."""
        return {"workers": [int(d) for d in self.worker_view],
                "incarnations": {int(d): int(self._inc.get(d, 0))
                                 for d in self.worker_view},
                "recoveries": len(self.recoveries),
                "admissions": len(self.admissions)}

    def chain_status(self) -> dict:
        """This chain's block of the nested ``Run.status()`` schema
        (``{"progress", "wire", "membership"}`` — docs/operations.md)."""
        return {
            "progress": {
                "batches_done": len({b for b, _ in self.loss_log}),
                "last_committed": int(self._committed),
                "num_batches": int(self.cfg.num_batches),
                "start_batch": int(self.cfg.start_batch)},
            "wire": self.transport.stats_snapshot(),
            "membership": self.membership(),
        }

    def _send_all(self, worker_ids, kind, payload_fn):
        for i, dev in enumerate(worker_ids):
            self.transport.send(COORD, dev, kind, payload_fn(i, dev))

    def _addrs_payload(self, worker_ids) -> dict:
        """{dev -> (host, port)} for the listed workers, from their hellos.
        Piggybacked on segment/refit payloads so every peer can reach a
        device admitted after that peer's own bring-up (its startup
        ``addr_of`` predates the joiner). Empty under the queue transport
        (no hellos carry addresses)."""
        return {dev: list(self._dev_addrs[dev]) for dev in worker_ids
                if dev in self._dev_addrs}

    def _collect(self, kinds: set, expect: int, timeout: float,
                 on_msg=None) -> int:
        """Drain COORD inbox until `expect` messages of `kinds` arrived."""
        got = 0
        deadline = time.monotonic() + timeout
        while got < expect and time.monotonic() < deadline:
            msg = self.transport.recv(COORD, timeout=self.cfg.poll)
            if msg is None:
                continue
            self._absorb(msg)
            if msg.kind in kinds:
                got += 1
            if on_msg is not None:
                on_msg(msg)
        return got

    def _absorb(self, msg):
        """Bookkeeping common to ALL receive loops. Centralized so that a
        seg_done / commit / hb drained during _probe or a _collect phase is
        never lost (losing a seg_done would wedge _abort_segment; losing a
        commit would regress the restart point)."""
        # ANY message from a worker proves liveness — not just heartbeats
        if msg.src != COORD:
            self._last_hb[msg.src] = time.monotonic()
        if msg.kind == "loss":
            gb, v = msg.payload
            if 0 <= gb < len(self.losses):
                self.losses[gb] = v
            self.loss_log.append((gb, v))
        elif msg.kind == "ready":
            # recorded here (not in _redistribute's own loop) so an ack
            # drained by ANY nested receive loop — a probe, an abort
            # drain — is never lost
            v = msg.payload.get("version")
            self._ready_acks.setdefault(v, set()).add(msg.src)
            self._ready_missing.setdefault(v, []).extend(
                msg.payload.get("missing", []))
        elif msg.kind in ("global_put", "ov_global_put"):
            # ov_global_put is the overlap scheduler's deferred shipment —
            # same store semantics, distinct wire kind so transport stats
            # attribute the overlapped bytes (kind class "replica_ov")
            self.global_store.put_many(msg.payload["batch"],
                                       msg.payload["layers"])
            # delta-skip: layers the sender verified unchanged since its
            # last ship here are re-stamped at the new batch, not resent
            self.global_store.refresh(msg.payload["batch"],
                                      msg.payload.get("same", {}))
        elif msg.kind == "hb":
            self._last_hb[msg.src] = time.monotonic()
        elif msg.kind == "seg_done":
            sg = msg.payload.get("shipped_gen", -1)
            if sg >= 0:
                self.shipped_gens[msg.src] = max(
                    self.shipped_gens.get(msg.src, -1), sg)
            if msg.payload.get("seg_id") == self._cur_seg:
                self._done[msg.src] = msg.payload
                self.stash_high_water[msg.src] = max(
                    self.stash_high_water.get(msg.src, 0),
                    msg.payload["stash_high_water"])
        elif msg.kind == "hello":
            self._absorb_hello(msg)
        elif msg.kind == "cap_probe_ack":
            self._cap_acks[msg.payload.get("dev", msg.src)] = msg.payload
        elif msg.kind == "commit":
            self._committed = max(self._committed, msg.payload)
            self.commit_times[int(msg.payload)] = \
                time.monotonic() - self._t0
            for dev, kb in list(self._kill.items()):
                if msg.payload >= kb:
                    self._log(f"KILL worker dev{dev} @batch {msg.payload}")
                    self._kill_worker(dev)
                    del self._kill[dev]
            if self._kill_all is not None and msg.payload >= self._kill_all:
                # whole-chain fault injection (fleet demo): every worker
                # except the central one dies at once — §III-F then trips
                # the min_workers floor and the chain collapses as a unit
                targets = [d for d in self.worker_view if d != 0]
                self._kill_all = None
                self._log(f"KILL chain: devs {targets} "
                          f"@batch {msg.payload}")
                for dev in targets:
                    self._kill_worker(dev)
            for dev, rb in list(self._respawn.items()):
                if msg.payload >= rb:
                    self._request_spawn(dev)
                    del self._respawn[dev]

    def _absorb_hello(self, msg) -> None:
        """Record a join/rejoin request. Epoch fencing happens HERE: a
        hello whose incarnation does not exceed the one last admitted for
        that device is a stale frame (duplicate startup announce, or a
        zombie's replay) and is dropped. Genuinely new incarnations stay
        pending until the device is out of the worker list — admission
        itself runs at control points (`_admit_pending`)."""
        p = msg.payload if isinstance(msg.payload, dict) else {}
        dev = int(p.get("dev", msg.src))
        inc = int(p.get("inc", 0))
        addr = ((p["host"], int(p["port"]))
                if "host" in p and "port" in p else None)
        if addr is not None:
            # remember where the device listens — propagated to peers in
            # segment/refit payloads so everyone can reach late joiners
            self._dev_addrs[dev] = addr
        if inc <= self._inc.get(dev, -1):
            if inc > 0 or dev not in self._inc:   # not the startup announce
                self._log(f"stale hello fenced: dev{dev} inc{inc}")
            return
        cur = self._pending_joins.get(dev)
        if cur is None or inc > cur["inc"]:
            self._pending_joins[dev] = {"inc": inc, "addr": addr}
            if (self.proto.overlap_replication
                    and self.cfg.capacity_source != "spec"):
                # overlap scheduler: launch the §III-D capacity probe at
                # hello time, so the joiner measures DURING the current
                # segment and `_joiner_capacity` finds the ack already
                # waiting instead of stalling admission on a fresh probe
                if addr is not None:
                    self.transport.add_route(dev, addr)
                self.transport.register(dev)
                self.transport.revive(dev)
                self._cap_acks.pop(dev, None)
                self.transport.send(
                    COORD, dev, "cap_probe",
                    {"range": (0, self.chain.num_layers - 1),
                     "repeats": 3})

    def _kill_worker(self, dev: int) -> None:
        """Inject a fatal fault. In-process workers crash directly (queue
        drained, transport fenced); an own-process worker gets a ``die``
        message and SIGKILLs itself — the coordinator learns of the death
        only through heartbeat silence, as with a real device."""
        if dev in self.workers:
            self.workers[dev].crash()
        else:
            # a few duplicates: SIGKILL is idempotent and "die" is
            # best-effort like any message — a drop-faulted transport must
            # not silently skip the scheduled fault injection. The payload
            # names the incarnation being killed, so a stale retry cannot
            # fell a relaunched worker on the same port (epoch fencing).
            for _ in range(3):
                self.transport.send(COORD, dev, "die",
                                    {"inc": self._inc.get(dev, 0)})

    def _fence_worker(self, dev: int) -> None:
        """Ensure a classified-dead worker is truly unreachable before
        recovery renumbers around it (a zombie's late messages must not
        corrupt the new epoch)."""
        if dev in self.workers:
            self.workers[dev].crash()
        else:
            self.transport.kill(dev)

    # ------------------- elastic membership (admission) -------------------

    def _ensure_spec(self, dev: int) -> None:
        """Grow ``self.specs`` to cover ``dev`` — device ids need not be
        contiguous (an operator may hot-join ``--dev 5`` into a 3-device
        cluster); gap devices get default specs too, since both the spec
        capacity branch and worker construction index by device id."""
        while len(self.specs) <= dev:
            self.specs.append(DeviceSpec(f"dev-{len(self.specs)}"))

    def _request_spawn(self, dev: int) -> None:
        """A scheduled relaunch (``cfg.rejoin`` / ``cfg.join_after``)
        fired. The actual launch is DEFERRED to the next control point at
        which the device is out of the worker list: a rejoin scheduled
        right after the kill must not race §III-F fencing of the old
        incarnation."""
        inc = self._inc.get(dev, 0) + 1
        self._spawn_queue[dev] = inc
        self._log(f"relaunch requested: dev{dev} inc{inc}")

    def _spawn_local(self, dev: int, inc: int) -> None:
        """In-process (queue transport) relaunch: a FRESH Worker thread for
        the device (threads cannot restart; state starts empty, exactly
        like a rebooted edge device). It announces itself with a hello —
        admission still flows through the same path as a TCP rejoin."""
        self.transport.register(dev)
        w = Worker(dev, self.chain, self.data_fn, self.transport, self.cfg,
                   self.abort_event, self.specs[dev], self.layout,
                   incarnation=inc, announce=True)
        self.workers[dev] = w
        w.start()

    def _await_scheduled_joiners(self, worker_ids: list) -> None:
        """Bounded wait for a spawned joiner's hello so admission lands at
        THIS control point instead of segments later (a fresh process
        cold-starts JAX). ``cfg.join_wait`` caps the wait per joiner — a
        no-show is logged and abandoned, never waited on again."""
        while True:
            now = time.monotonic()
            waiting = [d for d in self._join_deadline
                       if d not in self._pending_joins
                       and d not in worker_ids]
            for d in [d for d in waiting if now >= self._join_deadline[d]]:
                del self._join_deadline[d]
                waiting.remove(d)
                self._log(f"joiner dev{d} never said hello — giving up")
            if not waiting:
                return
            msg = self.transport.recv(COORD, timeout=self.cfg.poll)
            if msg is not None:
                self._absorb(msg)

    def _joiner_capacity(self, dev: int, b0: int, profile) -> float:
        """Capacity estimate for a joiner BEFORE its first segment: the
        spec'd value under ``capacity_source='spec'`` (deterministic —
        what the transport-parity tests rely on), else a live capacity
        probe — the joiner times an eager forward over the whole chain and
        the ratio against the central node's profiled forward time is its
        Eq. 1 capacity. No answer within the window -> the paper's
        homogeneity assumption (1.0) until measured."""
        if self.cfg.capacity_source == "spec":
            c0 = self.specs[0].capacity_at(b0)
            return self.specs[dev].capacity_at(b0) / max(c0, 1e-12)
        if dev not in self._cap_acks:
            # no hello-time probe answered yet (drain mode, or the early
            # probe raced the joiner's bring-up): probe now and wait
            L = self.chain.num_layers
            self.transport.send(COORD, dev, "cap_probe",
                                {"range": (0, L - 1), "repeats": 3})
            deadline = time.monotonic() + max(2.0,
                                              5 * self.proto.detect_timeout)
            while dev not in self._cap_acks \
                    and time.monotonic() < deadline:
                msg = self.transport.recv(COORD, timeout=self.cfg.poll)
                if msg is not None:
                    self._absorb(msg)
        ack = self._cap_acks.pop(dev, None)
        if ack is None:
            self._log(f"cap_probe dev{dev}: no answer, assuming C=1.0")
            return 1.0
        ref = float(np.sum(profile.fwd_times))
        return max(float(ack["t"]) / max(ref, 1e-12), 1e-6)

    def _admit_pending(self, worker_ids, part, est, profile, state,
                       partitions, b0):
        """Admission commit, run at control points: launch deferred spawns,
        wait (bounded) for their hellos, then fold every admissible joiner
        into the cluster — un-fence its transport, form its capacity,
        re-solve the §III-D partition over the GROWN worker list, and
        redistribute slices (the joiner fetches everything; peers donate
        per plan, with the usual chain/global §III-F fallbacks). Returns
        ``(worker_ids, part, est, b0, admitted)``. A death during the
        expansion falls into the standard shortfall -> probe -> §III-F
        recovery machinery, so a failed admission can shrink but never
        wedge the run."""
        for dev, inc in list(self._spawn_queue.items()):
            if dev in worker_ids:
                continue                   # §III-F has not evicted it yet
            del self._spawn_queue[dev]
            self._join_deadline[dev] = time.monotonic() + self.cfg.join_wait
            self._ensure_spec(dev)
            if self.spawner is not None:
                self.remote_devs.add(dev)
                self._log(f"spawning dev{dev} inc{inc} (process)")
                self.spawner(dev, inc)
            elif self.transport.is_networked:
                # socket transport without a spawner (multi-host
                # coordinator role): this process cannot host a worker
                # thread for a remote device — the operator relaunches the
                # worker's own command with --incarnation bumped instead
                self._join_deadline.pop(dev, None)
                self._log(f"cannot spawn dev{dev} here (no spawner); "
                          f"relaunch it on its host with a bumped "
                          f"incarnation")
            else:
                self._log(f"spawning dev{dev} inc{inc} (thread)")
                self._spawn_local(dev, inc)
        self._await_scheduled_joiners(worker_ids)
        ready = {dev: info for dev, info in self._pending_joins.items()
                 if dev not in worker_ids}
        if not ready:
            return worker_ids, part, est, b0, False
        devs = sorted(ready)
        est_new = est
        for dev in devs:
            info = ready[dev]
            self._pending_joins.pop(dev, None)
            self._join_deadline.pop(dev, None)
            self._inc[dev] = info["inc"]
            if dev not in self.workers:
                # no local thread for it -> it lives in its own process
                # (covers operator-relaunched workers on other hosts that
                # were never in the startup remote set)
                self.remote_devs.add(dev)
            self._ensure_spec(dev)
            if info.get("addr") is not None:
                self.transport.add_route(dev, info["addr"])
            self.transport.register(dev)
            self.transport.revive(dev)
            self.transport.send(COORD, dev, "admit",
                                {"dev": dev, "inc": info["inc"],
                                 "batch": b0,
                                 "wire": self.wire.to_payload()})
            est_new = est_new.add_worker(
                self._joiner_capacity(dev, b0, profile))
        new_ids = list(worker_ids) + devs
        self.bandwidth = protocol.expand_bandwidth(self.bandwidth,
                                                   max(new_ids) + 1)
        new_part = protocol.solve_from_estimates(
            profile, self.bandwidth, new_ids, est_new,
            self.proto.comm_factor)
        plans = protocol.plan_admission(new_part, part, len(worker_ids))
        self._log(f"admit devs {devs}: {part.counts} -> "
                  f"{new_part.counts} @batch {b0}")
        shortfall = self._redistribute(new_part, plans, new_ids,
                                       version=b0, kind="repart")
        if shortfall:
            # a death during the expansion (possibly the joiner itself):
            # standard §III-F recovery over the EXPANDED list — survivors
            # still serve their pre-refit slices, the global store
            # backstops the rest
            state.enter_recovery()
            worker_ids, part, est, b0 = self._handle_shortfall(
                shortfall, new_ids, new_part, est_new, profile, state,
                partitions)
            return worker_ids, part, est, b0, True
        partitions.append((b0, new_part.points))
        self.admissions.append({"devs": devs,
                                "incs": [self._inc[d] for d in devs],
                                "batch": b0,
                                "partition": new_part.points})
        self._log(f"admitted: {len(new_ids)} workers, "
                  f"partition {new_part.counts}")
        return new_ids, new_part, est_new, b0, True

    # ----------------------------- phases --------------------------------

    def _await_remote_workers(self, optional: bool = False,
                              timeout: Optional[float] = None) -> set:
        """Block until every own-process worker has been heard from (its
        ``hello`` or first heartbeat) — their interpreters cold-start
        torch and CUDA, so this gate keeps segment 0 from racing the
        cluster bring-up.
        Returns the devices heard. ``optional`` (coordinator relaunch):
        a no-show is not fatal — the caller shrinks the worker list to
        the survivors instead of refusing to come back up."""
        if not self.remote_devs:
            return set()
        heard: set = set()
        deadline = time.monotonic() + (timeout if timeout is not None
                                       else self.cfg.segment_timeout)
        while len(heard) < len(self.remote_devs) \
                and time.monotonic() < deadline:
            msg = self.transport.recv(COORD, timeout=self.cfg.poll)
            if msg is None:
                continue
            self._absorb(msg)
            if msg.src in self.remote_devs and msg.kind in ("hello", "hb"):
                heard.add(msg.src)
        missing = sorted(self.remote_devs - heard)
        if missing and not optional:
            raise RuntimeError(f"worker processes never connected: {missing}")
        if missing:
            self._log(f"workers not heard from at relaunch: {missing} — "
                      f"resuming without them")
        self._log(f"remote workers connected: {sorted(heard)}")
        return heard

    def _replicate(self, batch: int, do_chain: bool, do_global: bool,
                   part: PartitionResult, worker_ids: list,
                   full: bool = False, barrier: bool = False):
        """``full`` forces a whole-slice resend (delta-skip shadows
        discarded): set at batch 0 and when re-seeding after an elastic
        admission — a peer with a fresh (empty) store must never be
        'skipped' into a coverage hole. ``barrier`` marks a round whose
        caller needs the receiving store complete on return (fleet sync,
        final collect): it drains even under ``overlap_replication`` —
        the shared ``ProtocolConfig.replication_mode`` decision."""
        n = len(worker_ids)
        mode = self.proto.replication_mode(seeding=full, barrier=barrier)
        overlap = mode == "overlap"
        self._send_all(worker_ids, "replicate",
                       lambda i, dev: {"batch": batch, "chain": do_chain,
                                       "global": do_global, "stage": i,
                                       "chain_to": worker_ids[(i + 1) % n],
                                       "full": full, "overlap": overlap})
        # short ack window: a worker that died right at the segment boundary
        # (its seg_done already sent) must not stall the control plane for
        # segment_timeout — the NEXT segment's heartbeat monitor will catch
        # it and run the §III-F path
        got = self._collect({"replicated"}, n,
                            timeout=max(1.0, 2 * self.proto.detect_timeout))
        kind = ("chain+global" if do_chain and do_global
                else "chain" if do_chain else "global")
        tag = " (overlapped)" if overlap else ""
        if got < n:
            self._log(f"{kind} replication @batch {batch}{tag}: only "
                      f"{got}/{n} acks — continuing, failure detection "
                      f"will follow")
        else:
            self._log(f"{kind} replication @batch {batch}{tag}")
        if do_global:
            # per-sender FIFO puts every worker's global_put ahead of its
            # "replicated" ack, so by now the store holds this round's
            # snapshots (short-ack stragglers only make the floor
            # conservative) — the right moment to commit durable state
            self._durable_sync(part, worker_ids)

    def _durable_sync(self, part: PartitionResult, worker_ids: list) -> None:
        """Commit the durable control plane (run_dir runs only): fsync the
        disk replica tier, then atomically rewrite the run manifest naming
        the newest batch the tier fully covers. Ordering matters — the
        manifest must never name a batch the disk cannot serve."""
        if self.run_dir is None:
            return
        self.global_store.sync()
        stamps = self.global_store.batches(tier=LayerReplicaStore.GLOBAL)
        L = self.chain.num_layers
        floor = min((stamps.get(j, -1) for j in range(L)), default=-1)
        # a replication at control point b snapshots weights that have
        # trained batches [0, b) — so the newest batch the disk tier can
        # replay PAST is b-1, and a resume restarts at last_committed + 1
        last = int(floor) - 1 if floor > 0 else -1
        state = {
            "last_committed": last,
            "partition": [int(p) for p in part.points],
            "worker_ids": [int(d) for d in worker_ids],
            "incarnations": {str(d): int(self._inc.get(d, 0))
                             for d in worker_ids},
            "addr_of": {str(n): [a[0], int(a[1])]
                        for n, a in self.transport.addresses().items()},
            "wire": self.wire.to_payload(),
            "num_batches": int(self.cfg.num_batches),
        }
        RunManifest(config=self._manifest_config, state=state).save(
            self.run_dir)
        self._log(f"manifest committed: last_committed={last}")

    def _redistribute(self, part_new: PartitionResult, plans, worker_ids,
                      version: int, kind: str) -> list:
        """Ship a re-partition/recovery and collect ``ready`` acks (matched
        by ``version`` so a stale ack from an aborted earlier refit is
        never counted). Returns the devices that did NOT ack in time —
        empty on success; the caller decides whether a shortfall means a
        dead worker (run §III-F) or a genuine wedge (raise). Unserved
        layers are always fatal: training on a hole is silent corruption."""
        # reset BEFORE sending: a version number can recur (an identity
        # refit then a real recovery at the same restart batch) and stale
        # acks must not satisfy the new round
        self._ready_acks[version] = set()
        self._ready_missing[version] = []
        addrs = self._addrs_payload(worker_ids)
        self._send_all(
            worker_ids, kind,
            lambda i, dev: {"stage": i, "n": len(worker_ids),
                            "range": part_new.ranges[i],
                            "stage_devs": list(worker_ids),
                            "need": plans[i].need, "local": plans[i].local,
                            "version": version, "addrs": addrs})
        pending = self._await_ready(version, worker_ids)
        missing = self._ready_missing.get(version, [])
        if missing:
            raise RuntimeError(f"redistribution left layers unserved: "
                               f"{sorted(set(missing))}")
        return pending

    def _await_ready(self, version: int, worker_ids: list) -> list:
        """Collect version-keyed ``ready`` acks with fail-fast probing
        (shared by ``_redistribute`` and the fleet ``_install_all``).
        Returns the devices that did NOT ack in time."""
        deadline = time.monotonic() + self.cfg.segment_timeout

        def _pending():
            return [d for d in worker_ids
                    if d not in self._ready_acks[version]]

        while _pending() and time.monotonic() < deadline:
            msg = self.transport.recv(COORD, timeout=self.cfg.poll)
            if msg is not None:
                self._absorb(msg)
            # fail fast on in-flight death: a pending worker that has gone
            # heartbeat-silent is probed NOW rather than waiting out the
            # whole collection window (the §III-F timer keeps running)
            now = time.monotonic()
            stale = [d for d in _pending() if d != worker_ids[0]
                     and now - self._last_hb.get(d, now)
                     > self.proto.detect_timeout]
            if stale:
                responses = self._probe(worker_ids)
                case, dead = fault_sm.classify(responses)
                if case is fault_sm.Case.FAILURES and dead:
                    break                       # hand shortfall to caller
                for d in stale:                 # transient: keep waiting
                    self._last_hb[d] = time.monotonic()
        return _pending()

    # ------------------- fleet aggregation (data axis) --------------------

    def _install_all(self, flats: dict, part: PartitionResult,
                     worker_ids: list, version: int) -> list:
        """Rebroadcast fleet-aggregated weights through the existing
        install path: every worker gets its stage's per-layer packed
        slices and re-acks ``ready`` at ``version`` (installs are
        idempotent per (range, version), so duplicates are safe). Returns
        the devices that never acked — same contract as
        ``_redistribute``, so callers reuse the shortfall machinery."""
        self._ready_acks[version] = set()
        self._ready_missing[version] = []
        addrs = self._addrs_payload(worker_ids)
        for i, dev in enumerate(worker_ids):
            a, e = part.ranges[i]
            self.transport.send(
                COORD, dev, "install",
                {"range": (a, e),
                 "layers": {j: flats[j] for j in range(a, e + 1)},
                 "version": version, "stage": i,
                 "wire": self.wire.to_payload(), "addrs": addrs})
        return self._await_ready(version, worker_ids)

    def _fleet_sync(self, b0: int, part: PartitionResult, worker_ids: list,
                    fresh_global: bool) -> list:
        """Fleet weight-aggregation barrier (ROADMAP direction 2, see
        docs/protocol.md §9). At a ``fleet_due`` boundary: (1) force a
        global replication unless this boundary's cadence just did one —
        per-sender FIFO guarantees the ``global_put``s precede their acks,
        so the store now holds this chain's full post-b0 snapshot; (2)
        contribute the per-layer packed slices to the fleet barrier and
        block until it publishes (all live chains arrived, or the deadline
        degraded the stragglers); (3) install the fleet mean back onto
        every worker at ``version=b0``. Returns the install shortfall
        (empty when nothing had to be installed)."""
        if not fresh_global:
            # barrier: the aggregate below reads the store NOW, so this
            # round must drain even under the overlap scheduler
            self._replicate(b0, False, True, part, worker_ids,
                            barrier=True)
        L = self.chain.num_layers
        snap = {}
        for j in range(L):
            got = self.global_store.get(j, tier=LayerReplicaStore.GLOBAL)
            if got is not None:
                snap[j] = host_array(got[1])
        if len(snap) < L:
            # possible only if the forced replication above lost layers to
            # a mid-boundary death; the liveness sweep will handle the
            # corpse — contribute nothing rather than a partial model
            self._log(f"fleet sync @batch {b0}: store covers "
                      f"{len(snap)}/{L} layers — sitting this round out")
            return []
        agg = self.aggregator.aggregate(self.chain_id, b0, snap)
        if agg is None:
            # solo round (every other chain degraded/absent) or barrier
            # closed: this chain's weights ARE the fleet state already
            self._log(f"fleet sync @batch {b0}: solo round")
            return []
        pending = self._install_all(agg, part, worker_ids, version=b0)
        if not pending:
            self._log(f"fleet mean installed @batch {b0}")
        return pending

    def _run_segment(self, b0: int, nb: int, part: PartitionResult,
                     worker_ids: list):
        """Returns (ok, stats | suspects, committed)."""
        n = len(worker_ids)
        self._seg_counter += 1
        self._cur_seg = self._seg_counter
        self._done = {}
        self._committed = b0 - 1
        self._last_hb = {dev: time.monotonic() for dev in worker_ids}
        addrs = self._addrs_payload(worker_ids)
        self._send_all(
            worker_ids, "segment",
            lambda i, dev: {"stage": i, "n": n, "b0": b0, "nb": nb,
                            "stage_devs": list(worker_ids),
                            "seg_id": self._cur_seg, "addrs": addrs})
        deadline = time.monotonic() + self.cfg.segment_timeout
        while len(self._done) < n:
            now = time.monotonic()
            if now > deadline:
                # a wedge without heartbeat loss (e.g. a dropped act/grad —
                # there is no data-plane retransmission): hand it to the
                # stall/restart path rather than crashing the run
                return False, {"suspects": []}, self._committed
            msg = self.transport.recv(COORD, timeout=self.cfg.poll)
            if msg is not None:
                self._absorb(msg)
            suspects = [dev for dev in worker_ids
                        if dev not in self._done
                        and now - self._last_hb[dev]
                        > self.proto.detect_timeout]
            if suspects:
                return False, {"suspects": suspects}, self._committed
        return True, dict(self._done), self._committed

    def _probe(self, worker_ids: list) -> dict:
        """§III-F: on timer expiry the central node probes every worker."""
        for dev in worker_ids:
            if dev != 0:
                self.transport.send(COORD, dev, "probe", {})
        responses: dict[int, Optional[str]] = {dev: None for dev in worker_ids
                                               if dev != 0}
        deadline = time.monotonic() + max(10 * self.proto.probe_rtt, 0.3)
        while time.monotonic() < deadline:
            msg = self.transport.recv(COORD, timeout=self.cfg.poll)
            if msg is None:
                continue
            self._absorb(msg)
            if msg.kind in ("probe_ack", "hb") and msg.src in responses:
                responses[msg.src] = "ok"
            if all(r is not None for r in responses.values()):
                break
        return responses

    def _abort_segment(self, worker_ids: list, dead: set):
        """Drain the wedged pipeline: wait until every survivor has posted
        seg_done for the CURRENT segment (self._done, fed by _absorb from
        any receive loop — including the probe that preceded this call).
        In-process workers see the shared abort event; own-process workers
        get an ``abort`` message — resent periodically while the drain is
        pending, because a message (unlike the shared event) can be lost
        and a worker wedged in ``_await`` has no other way out."""
        self.abort_event.set()

        def _send_aborts():
            for dev in self.remote_devs:
                if dev not in dead and self.transport.is_alive(dev):
                    self.transport.send(COORD, dev, "abort", {})

        _send_aborts()
        resend_every = max(0.1, self.proto.detect_timeout / 2)
        last_sent = time.monotonic()
        deadline = time.monotonic() + self.cfg.segment_timeout
        while time.monotonic() < deadline:
            if all(d in self._done for d in worker_ids if d not in dead):
                break
            if time.monotonic() - last_sent > resend_every:
                _send_aborts()
                last_sent = time.monotonic()
            msg = self.transport.recv(COORD, timeout=self.cfg.poll)
            if msg is not None:
                self._absorb(msg)
        self.abort_event.clear()

    # ----------------------- durable resume helpers -----------------------

    def request_stop(self) -> None:
        """Ask the batch loop to wind down at the next boundary (clean
        teardown, manifest intact) — the ``Run.stop()`` entry point.
        Thread-safe; idempotent."""
        self._stop_requested.set()

    def _startup_flats(self, a: int, e: int) -> dict:
        """Fresh-run initial weights for layers [a, e]: the chain's init
        params, unless this chain is being re-admitted to a fleet mid-run
        (``init_flats``: the last published fleet mean — a rebooted chain
        must rejoin the fleet's trajectory, not restart from scratch)."""
        if self.init_flats is not None:
            return {j: host_array(self.init_flats[j])
                    for j in range(a, e + 1)}
        return {j: self.layout.pack_layer(j, self.chain.params[j])
                for j in range(a, e + 1)}

    def _resume_flats(self, a: int, e: int) -> dict:
        """Initial slice weights for layers [a, e] on a resumed run: the
        disk-backed global store's committed snapshots, falling back to
        init params for any layer the store never covered (possible only
        when resuming a manifest with last_committed = -1)."""
        out = {}
        for j in range(a, e + 1):
            got = self.global_store.get(j, tier=LayerReplicaStore.GLOBAL)
            out[j] = (host_array(got[1]) if got is not None
                      else self.layout.pack_layer(j, self.chain.params[j]))
        return out

    def _readopt_remote(self, worker_ids: list, part: PartitionResult,
                        version: int) -> None:
        """Coordinator re-adoption (docs/protocol.md §8): fold LIVE remote
        workers — survivors of a coordinator crash, mid-segment, waiting on
        acts that will never come — back under this control plane.

        Per pending worker, send ``abort`` (releases a ``_await`` wedge;
        survivors see the old segment as a drain) THEN the ``install`` for
        its resumed slice, and RESEND the pair until its ``ready`` ack
        lands: a worker deep in ``_await`` only dispatches aborts, so an
        install arriving there would be dropped on the floor — the resend
        loop plus ``_do_install`` idempotency makes the handshake converge
        regardless of where the worker was when the old coordinator died.
        Per-sender FIFO keeps abort-before-install ordering."""
        remote = [d for d in worker_ids if d in self.remote_devs]
        if not remote:
            return
        self._ready_acks[version] = set()
        self._ready_missing[version] = []
        deadline = time.monotonic() + self.cfg.segment_timeout
        resend_every = max(0.5, self.proto.detect_timeout)
        last_sent = 0.0
        while True:
            pending = [d for d in remote
                       if d not in self._ready_acks.get(version, set())]
            if not pending:
                break
            if time.monotonic() > deadline:
                raise RuntimeError(
                    f"re-adoption incomplete: {pending} never acked the "
                    f"resumed install")
            if time.monotonic() - last_sent > resend_every:
                addrs = self._addrs_payload(worker_ids)
                for dev in pending:
                    i = worker_ids.index(dev)
                    a, e = part.ranges[i]
                    self.transport.send(COORD, dev, "abort", {})
                    self.transport.send(
                        COORD, dev, "install",
                        {"range": (a, e), "layers": self._resume_flats(a, e),
                         "version": version, "stage": i,
                         "wire": self.wire.to_payload(), "addrs": addrs})
                last_sent = time.monotonic()
            msg = self.transport.recv(COORD, timeout=self.cfg.poll)
            if msg is not None:
                self._absorb(msg)
        self._log(f"re-adopted workers {remote} @version {version}")

    # ------------------------------- run ---------------------------------

    def run(self) -> LiveResult:
        """Train ``cfg.num_batches`` batches under the full protocol and
        return the ``LiveResult`` (losses, partitions, events, recovery
        records). Installs slices, starts local workers / waits for remote
        ones, then drives the segment loop; always tears the cluster down
        (threads joined, remote workers told to stop)."""
        cfg, proto = self.cfg, self.proto
        L = self.chain.num_layers
        profile = cfg.profile or self.chain.measure_profile(
            self.data_fn(0), repeats=cfg.profile_repeats)
        # first CUDA use (kernel build, cuDNN set-up) here, before any
        # worker's heartbeat-timed segment
        warm_up(self.chain, self.data_fn(0))
        worker_ids = list(self._startup_ids)
        v0 = cfg.start_batch
        state = fault_sm.TrainingState(learning_rate=cfg.lr)

        # startup: install slices everywhere (directly for local workers,
        # over the wire for own-process ones), then replicate so replicas
        # exist even for a failure before the first cadence point. A fresh
        # run installs init weights at version 0; a RESUMED run installs
        # the disk-backed store's committed snapshots at version
        # ``start_batch``, re-adopting live remote workers through the
        # abort+install resend handshake. The WHOLE startup sits inside
        # the teardown try: a failed bring-up (workers never connect,
        # installs unacked) must not leak worker/heartbeat threads or
        # leave remote processes polling forever.
        try:
            if cfg.resume:
                # survivors-only membership: workers that died with (or
                # since) the old coordinator are dropped here; they can
                # still rejoin later through the usual hello/admit path
                heard = self._await_remote_workers(optional=True)
                worker_ids = [d for d in worker_ids
                              if d not in self.remote_devs or d in heard]
                if not worker_ids or worker_ids[0] != 0:
                    raise RuntimeError(
                        "resume requires the central worker (device 0)")
            else:
                self._await_remote_workers()
            est = CapacityEstimator(profile.exec_times, len(worker_ids),
                                    ema=cfg.capacity_ema)
            part = uniform_partition(L, len(worker_ids))
            partitions = [(v0, part.points)]
            for i, dev in enumerate(worker_ids):
                a, e = part.ranges[i]
                if dev in self.workers:
                    flats = (self._resume_flats(a, e) if cfg.resume
                             else self._startup_flats(a, e))
                    self.workers[dev].install((a, e), flats, version=v0)
                elif not cfg.resume:
                    self.transport.send(COORD, dev, "install",
                                        {"range": (a, e),
                                         "layers": self._startup_flats(a, e),
                                         "version": v0, "stage": i,
                                         "wire": self.wire.to_payload()})
            for w in self.workers.values():
                w.start()
            if cfg.resume:
                self._readopt_remote(worker_ids, part, v0)
            elif self.remote_devs:
                got = self._collect({"ready"}, len(self.remote_devs),
                                    timeout=self.cfg.segment_timeout)
                if got < len(self.remote_devs):
                    raise RuntimeError(
                        f"remote install incomplete: {got}/"
                        f"{len(self.remote_devs)} workers acked")
            est, partitions = self._run_protocol(est, part, partitions,
                                                 worker_ids, profile, state)
        finally:
            # error paths (wedged restarts, incomplete redistribution) must
            # not leak N worker + heartbeat threads — and own-process
            # workers must be told to exit so their processes can be joined
            for dev in sorted(self.remote_devs):
                if not self.transport.is_alive(dev) \
                        and dev in self._pending_joins:
                    # a joiner process that was never admitted is alive
                    # behind the fence of its dead predecessor: un-fence so
                    # the stop reaches it and its process can be joined
                    self.transport.revive(dev)
                if self.transport.is_alive(dev):
                    self.transport.send(COORD, dev, "stop", {})
            for w in self.workers.values():
                if self.transport.is_alive(w.dev):
                    self.transport.send(COORD, w.dev, "stop", {})
                w.shutdown()
            for w in self.workers.values():
                if w.ident is not None:      # never started -> nothing to join
                    w.join(timeout=5.0)
        return LiveResult(
            losses=self.losses, loss_log=self.loss_log,
            partitions=partitions, events=self.events,
            commit_times=dict(self.commit_times),
            capacities=np.array(est.capacities),
            transport_stats=self.transport.stats_snapshot(),
            stash_high_water=dict(self.stash_high_water),
            recoveries=self.recoveries, admissions=self.admissions,
            replica_report=self.global_store.nbytes_report(),
            final_flats=self.final_flats,
            shipped_gens=dict(self.shipped_gens))

    def _run_protocol(self, est, part, partitions, worker_ids, profile,
                      state):
        """The coordinator's batch loop (factored out of run() so thread
        teardown can wrap it)."""
        cfg, proto = self.cfg, self.proto
        b0 = cfg.start_batch
        self._replicate(b0, True, True, part, worker_ids, full=True)

        B = cfg.num_batches
        stall_at, stalls = -1, 0          # no-progress guard for restarts
        while b0 < B:
            self.worker_view = list(worker_ids)
            if self._stop_requested.is_set():
                self._log(f"stop requested @batch {b0}")
                break
            pts = [p for p in proto.control_points(B) if p > b0]
            nxt = pts[0] if pts else B
            ok, info, committed = self._run_segment(b0, nxt - b0, part,
                                                    worker_ids)
            if not ok:
                # ---- §III-F failure path --------------------------------
                state.enter_recovery()
                responses = self._probe(worker_ids)
                case, dead = fault_sm.classify(responses)
                if case is not fault_sm.Case.FAILURES:
                    # transient: all responded — restart the segment.
                    # (self._committed includes commits drained during probe)
                    restart = self._committed + 1
                    if restart == stall_at:
                        stalls += 1
                        if stalls >= 3:
                            raise RuntimeError(
                                f"segment restarting @batch {restart} made "
                                f"no progress {stalls} times — wedged")
                    else:
                        stall_at, stalls = restart, 1
                    self._abort_segment(worker_ids, set())
                    state.reset_after_recovery(restart)
                    # identity refit: collapse every stash onto its newest
                    # version so re-run batches have well-defined (drain)
                    # semantics instead of stale vertical-sync fallbacks
                    plans = [RedistributionPlan(
                        need={}, local=list(range(a, e + 1)))
                        for a, e in part.ranges]
                    shortfall = self._redistribute(part, plans, worker_ids,
                                                   version=restart,
                                                   kind="recover")
                    if shortfall:
                        # a worker died between the probe and the refit
                        worker_ids, part, est, b0 = \
                            self._handle_shortfall(shortfall, worker_ids,
                                                   part, est, profile,
                                                   state, partitions)
                    else:
                        b0 = restart
                        self._log(f"transient stall; restart @batch {b0}")
                    continue
                worker_ids, part, est, b0 = self._run_failure_recovery(
                    dead, worker_ids, part, est, profile, state, partitions)
                continue

            # ---- capacity samples (Eqs. 1-3) ----------------------------
            # Eq. 1 is a ratio against the central node's CURRENT speed.
            # The startup profile times layers eagerly, but the compiled
            # StageExecutor runs far faster than that, so raw
            # measured/profile ratios would make every worker look fast
            # relative to a central pinned at C_0 = 1. Calibrate by the
            # central worker's own measured-vs-profile factor (the spec
            # branch normalizes by c0 the same way).
            def _median_bt(dev):
                stats = info[dev]
                # median per-batch time: robust to first-call tracing
                # and thread-scheduling spikes
                bt = stats.get("batch_times") or [
                    stats["busy"] / max(stats["nb"], 1)]
                return float(np.median(bt))

            a0, e0 = part.ranges[0]
            ref0 = float(np.sum(profile.exec_times[a0:e0 + 1]))
            kappa = _median_bt(worker_ids[0]) / max(ref0, 1e-12)
            for i, dev in enumerate(worker_ids):
                a, e = part.ranges[i]
                if cfg.capacity_source == "spec":
                    c0 = self.specs[worker_ids[0]].capacity_at(b0)
                    meas = float(np.sum(profile.exec_times[a:e + 1])
                                 * self.specs[dev].capacity_at(b0)
                                 / max(c0, 1e-12))
                else:
                    meas = _median_bt(dev) / max(kappa, 1e-12)
                est.update(i, meas, a, e)
            state.committed_forward_id = nxt - 1
            state.committed_backward_id = nxt - 1
            b0 = nxt
            if b0 >= B:
                break

            # ---- boundary liveness sweep (§III-F fault timer) -----------
            # the paper's fault timer runs continuously at the central
            # node. A worker that died right as the segment drained (its
            # seg_done already sent) is silent NOW — catch it before a
            # control event tries to include it, not one segment later.
            now = time.monotonic()
            suspects = [dev for dev in worker_ids
                        if dev != worker_ids[0]
                        and now - self._last_hb.get(dev, now)
                        > proto.detect_timeout]
            if suspects:
                state.enter_recovery()
                responses = self._probe(worker_ids)
                case, dead = fault_sm.classify(responses)
                if case is fault_sm.Case.FAILURES and dead:
                    worker_ids, part, est, b0 = self._run_failure_recovery(
                        dead, worker_ids, part, est, profile, state,
                        partitions)
                    continue

            # ---- elastic admission (rejoin / hot-join) ------------------
            if self._spawn_queue or self._pending_joins \
                    or self._join_deadline:
                worker_ids, part, est, b0, admitted = self._admit_pending(
                    worker_ids, part, est, profile, state, partitions, b0)
                if admitted:
                    # re-seed replica tiers over the grown layout (a
                    # joiner's chain tier starts empty) and skip the
                    # regular cadence this boundary — fresh replicas were
                    # just made and the partition was just re-solved.
                    # full=True: a joiner must never be delta-skipped
                    # against a store its previous incarnation lost
                    self._replicate(b0, True, True, part, worker_ids,
                                    full=True)
                    continue

            # ---- replication cadence (§III-E) ---------------------------
            do_chain, do_global = proto.replication_due(b0)
            if do_chain or do_global:
                self._replicate(b0, do_chain, do_global, part, worker_ids)

            # ---- fleet aggregation barrier (data axis) ------------------
            if self.aggregator is not None and proto.fleet_due(b0):
                # an OVERLAPPED cadence round above has not landed in the
                # store yet — the barrier must run its own drained round
                fresh = (do_global
                         and proto.replication_mode() == "drain")
                shortfall = self._fleet_sync(b0, part, worker_ids,
                                             fresh_global=fresh)
                if shortfall:
                    # a worker died while the fleet mean was being
                    # installed: standard shortfall -> probe -> §III-F
                    state.enter_recovery()
                    worker_ids, part, est, b0 = self._handle_shortfall(
                        shortfall, worker_ids, part, est, profile,
                        state, partitions)
                    continue

            # ---- dynamic re-partition (§III-D) --------------------------
            if proto.repartition_due(b0):
                new_part = protocol.solve_from_estimates(
                    profile, self.bandwidth, worker_ids, est,
                    proto.comm_factor, static=self.cfg.static_partition)
                if protocol.refit_worthwhile(profile, self.bandwidth,
                                             worker_ids, est, part,
                                             new_part, proto):
                    plans = protocol.plan_repartition_all(
                        new_part, part, len(worker_ids))
                    self._log(f"re-partition {part.counts} -> "
                              f"{new_part.counts} @batch {b0}")
                    shortfall = self._redistribute(new_part, plans,
                                                   worker_ids, version=b0,
                                                   kind="repart")
                    if shortfall:
                        # a worker died during the re-partition: recover
                        # against the OLD partition — every live worker
                        # still serves its pre-refit slice (_pre_refit)
                        state.enter_recovery()
                        worker_ids, part, est, b0 = self._handle_shortfall(
                            shortfall, worker_ids, part, est, profile,
                            state, partitions)
                        continue
                    part = new_part
                    partitions.append((b0, part.points))
        self.worker_view = list(worker_ids)
        if cfg.collect_final:
            # one last global replication so the store holds the FINISHED
            # weights, then snapshot them into the result (fleet chains
            # average these into the fleet's final model; the aggregation
            # bench evaluates accuracy on them). Barrier: the snapshot
            # below reads the store immediately, so never overlap it
            self._replicate(b0, False, True, part, worker_ids,
                            barrier=True)
            L = self.chain.num_layers
            snap = {}
            for j in range(L):
                got = self.global_store.get(j,
                                            tier=LayerReplicaStore.GLOBAL)
                if got is not None:
                    snap[j] = host_array(got[1])
            self.final_flats = snap if len(snap) == L else None
        return est, partitions

    def _handle_shortfall(self, shortfall, worker_ids, part, est, profile,
                          state, partitions):
        """A redistribution ended with workers that never acked: decide
        dead-vs-wedged by probing. Dead -> §III-F recovery (returns the
        post-recovery view); all-normal -> the cluster is in an unknown
        mixed-partition state and proceeding would corrupt training, so
        fail loudly."""
        responses = self._probe(worker_ids)
        case, dead = fault_sm.classify(responses)
        if case is fault_sm.Case.FAILURES and dead:
            return self._run_failure_recovery(dead, worker_ids, part, est,
                                              profile, state, partitions)
        raise RuntimeError(f"redistribution incomplete: {sorted(shortfall)} "
                           f"never acked (probe says all alive)")

    def _run_failure_recovery(self, dead, worker_ids, part, est, profile,
                              state, partitions, depth: int = 0):
        """§III-F commit: fence the dead, drain survivors, renumber the
        worker list, re-solve the partition over survivor capacities, and
        redistribute weights per the recovery plans. Returns the new
        ``(worker_ids, part, est, restart_batch)``. A FURTHER failure
        during the recovery redistribution recurses (each round removes at
        least one worker, so depth is bounded by the cluster size)."""
        self._log(f"failure detected: devs {sorted(dead)}; probing done")
        for dev in dead:      # ensure a non-responder is truly gone
            self._fence_worker(dev)
        survivors = [d for d in worker_ids if d not in dead]
        if len(survivors) < max(1, self.cfg.min_workers):
            # whole-chain loss: recovering below the floor would leave a
            # straggler replica, so the chain collapses as a unit — the
            # fleet degrades to M-1 contributors and re-admits a fresh
            # chain at a later aggregation round (runtime/fleet.py)
            self._log(f"chain collapsed: {len(survivors)} survivors < "
                      f"min_workers={self.cfg.min_workers}")
            if self.aggregator is not None:
                self.aggregator.chain_dead(self.chain_id)
            raise ChainCollapsedError(self.chain_id, survivors,
                                      sorted(dead))
        for dev in worker_ids:      # release anyone mid-refit fetching from
            if dev not in dead:     # the corpse — abandon, don't backstop
                self.transport.send(COORD, dev, "refit_abort", {})
        self._abort_segment(worker_ids, set(dead))
        failed_pos = [worker_ids.index(d) for d in dead]
        dec = protocol.plan_failure_recovery(
            part, worker_ids, failed_pos, est, profile,
            self.bandwidth, self.proto.comm_factor,
            static=self.cfg.static_partition)
        restart = self._committed + 1
        state.reset_after_recovery(restart)
        shortfall = self._redistribute(dec.partition, dec.plans,
                                       dec.worker_ids, version=restart,
                                       kind="recover")
        worker_ids, part, est = dec.worker_ids, dec.partition, dec.est
        if shortfall:
            if depth + 1 >= self.cfg.num_workers:
                raise RuntimeError(
                    f"recovery redistribution incomplete: {shortfall}")
            responses = self._probe(worker_ids)
            case, dead2 = fault_sm.classify(responses)
            if case is fault_sm.Case.FAILURES and dead2:
                return self._run_failure_recovery(
                    dead2, worker_ids, part, est, profile, state,
                    partitions, depth + 1)
            raise RuntimeError(
                f"recovery redistribution incomplete: {shortfall} "
                f"never acked (probe says all alive)")
        partitions.append((restart, part.points))
        self.recoveries.append({"failed": sorted(dead), "restart": restart,
                                "partition": part.points})
        self._log(f"recovered: {len(worker_ids)} workers, "
                  f"partition {part.counts}, resume @batch {restart}")
        return worker_ids, part, est, restart


def run_live_training(chain: LayerChain, batches: list,
                      cfg: LiveConfig) -> LiveResult:
    """Convenience entry point: train `chain` on a cycling batch list under
    the full live FTPipeHD protocol. See examples/live_fault_tolerance.py."""
    data_fn = lambda gb: batches[gb % len(batches)]
    return Coordinator(chain, data_fn, cfg).run()
