"""Chain fleets: data-parallel replicated pipelines with periodic weight
aggregation (the fleet's "data axis" over the live runtime's "model axis").

FTPipeHD's live runtime trains ONE pipeline chain over N heterogeneous
devices (``runtime/live.py``). This module replicates that chain M times —
each replica ("chain") is a full coordinator + worker cluster with its own
§III-D partition, its own §III-F fault machinery, and a disjoint strided
shard of the deterministic batch stream (``WorkloadSpec.shard``) — and
couples the replicas only at a periodic weight-aggregation barrier:

    every K committed batches each chain snapshots its global replica
    store into per-layer packed flat f32 buffers, meets the other chains
    at a ``FleetAggregator`` barrier, and installs the element-wise mean
    (``stage_executor.aggregate_packed`` per layer) through the existing
    install/ready handshake.

Because the currency of the barrier is the per-layer PACKED buffer — the
same representation §III-E replication and §III-F redistribution already
move — aggregation is partition-agnostic: chains may be split differently
(heterogeneous clusters solve their own DP, ``core/partition.
solve_fleet_partitions``) and the fleet mean is still one stacked mean.

Fault tolerance composes along both axes:

  * a worker dying INSIDE a chain is §III-F business as usual (detect →
    classify → recover → redistribute), invisible to the fleet;
  * a chain collapsing below ``LiveConfig.min_workers`` raises
    ``ChainCollapsedError``; the fleet degrades to M-1 (the barrier stops
    waiting for the dead chain), and — with ``FleetConfig.readmit`` — a
    fresh incarnation of the chain is relaunched seeded from the NEXT
    published fleet mean (``init_flats``), rejoining the trajectory
    instead of restarting from init;
  * a chain that merely misses the barrier deadline is degraded the same
    way and re-admitted automatically the next time it shows up.

``run.RunConfig.fleet`` + ``Run`` drive this through the public API;
``launch/live_train.py --chains M --fleet-every K`` from the CLI.
"""
from __future__ import annotations

import dataclasses
import os
import queue
import threading
import time
from typing import Any, Dict, Optional

import numpy as np
import torch

from repro_torch.runtime import protocol
from repro_torch.runtime.qtensor import host_array
from repro_torch.runtime.stage_executor import aggregate_packed

# ============================ aggregation ops ============================


def fleet_average(snapshots: list) -> Dict[int, np.ndarray]:
    """Per-layer mean of chain snapshots (§III-C applied across the fleet).

    snapshots: [{layer -> packed flat f32}] with identical key sets — each
    entry is one chain's global-store view of the full model. Returns the
    fleet mean in the same {layer -> packed buffer} shape the coordinator
    install path consumes, as host numpy arrays. Snapshots may be numpy
    arrays or tensors; the mean is taken where the first one lives."""
    assert snapshots, "fleet_average of zero snapshots"
    layers = set(snapshots[0])
    for s in snapshots[1:]:
        assert set(s) == layers, (sorted(layers), sorted(s))
    return {j: host_array(aggregate_packed([_tensor(s[j])
                                            for s in snapshots]))
            for j in sorted(layers)}


def _tensor(a) -> torch.Tensor:
    """A tensor as it is; a host array copied into one (decoded wire
    arrays are read-only, which torch will not wrap)."""
    return a if torch.is_tensor(a) else torch.tensor(np.asarray(a))


def layer_aggregate_op(layout):
    """Adapter exposing the packed-buffer mean to PYTREE consumers: returns
    ``op(layer, trees) -> tree`` that packs each candidate version with the
    chain's ``ChainLayout``, means the flat buffers, and unpacks the result
    — so ``runtime/semantics.AsyncTrainingExecutor`` (Fig. 4 benchmark) and
    the live runtime aggregate through the SAME arithmetic. Trees hold
    tensors; the mean stays on their device."""

    def op(layer: int, trees: list):
        mean = aggregate_packed([layout.pack_layer(layer, t) for t in trees])
        return layout.unpack_layer(layer, mean)

    return op


# ============================ configuration ==============================

# config knobs that never belong in a manifest (fault injection is a
# per-launch experiment, not run state)
_FLEET_SKIP = frozenset({"kill_chain"})


@dataclasses.dataclass(frozen=True)
class FleetConfig:
    """The ``fleet`` block of ``run.RunConfig``. Defaults describe a
    single-chain run, so pre-fleet configs (and manifests) behave exactly
    as before this block existed."""
    chains: int = 1                  # M data-parallel pipeline replicas
    aggregate_every: int = 10        # K: barrier every K committed batches
    #   (rides ProtocolConfig.fleet_every into each chain's batch loop)
    barrier_timeout: float = 60.0    # seconds a round waits for a missing
    #   chain before degrading the fleet to the chains that showed up
    min_chain_workers: int = 1       # LiveConfig.min_workers per chain: a
    #   §III-F recovery leaving fewer live workers collapses the CHAIN
    #   (fail fast as a unit) instead of limping as a straggler replica
    chain_devices: Optional[tuple] = None   # ((capacity, ...), ...) — one
    #   inner tuple per chain = that chain's DeviceSpec capacities (and
    #   worker count); None = every chain uses LiveConfig.num_workers
    #   identical devices
    readmit: bool = True             # relaunch a collapsed chain after the
    #   next published round, seeded from that round's fleet mean
    kill_chain: Optional[tuple] = None      # (chain_id, batch): fault
    #   injection — SIGKILL every non-central worker of that chain when
    #   that batch commits (LiveConfig.kill_all_at), collapsing it

    def __post_init__(self):
        assert self.chains >= 1, self.chains
        if self.chain_devices is not None:
            # normalize json lists back to tuples so from_manifest round-
            # trips to an == config
            object.__setattr__(
                self, "chain_devices",
                tuple(tuple(float(c) for c in caps)
                      for caps in self.chain_devices))
            assert len(self.chain_devices) == self.chains, \
                (len(self.chain_devices), self.chains)
        if self.kill_chain is not None:
            object.__setattr__(self, "kill_chain",
                               (int(self.kill_chain[0]),
                                int(self.kill_chain[1])))

    def to_doc(self) -> dict:
        """JSON-safe manifest block (fault injection excluded)."""
        out = {}
        for f in dataclasses.fields(self):
            if f.name in _FLEET_SKIP:
                continue
            v = getattr(self, f.name)
            if f.name == "chain_devices" and v is not None:
                v = [list(caps) for caps in v]
            out[f.name] = v
        return out

    @classmethod
    def from_doc(cls, doc: Optional[dict]) -> "FleetConfig":
        """Inverse of ``to_doc``; ``None``/missing (pre-fleet manifests)
        means the single-chain default."""
        if not doc:
            return cls()
        kw = {k: v for k, v in doc.items()
              if k in {f.name for f in dataclasses.fields(cls)}
              and k not in _FLEET_SKIP}
        if kw.get("chain_devices") is not None:
            kw["chain_devices"] = tuple(tuple(caps)
                                        for caps in kw["chain_devices"])
        return cls(**kw)


# ========================= aggregation barrier ===========================


class _Round:
    """One aggregation round (keyed by the committed batch b0)."""

    __slots__ = ("t0", "arrivals", "result", "contributors", "degraded",
                 "published")

    def __init__(self, t0: float):
        self.t0 = t0
        self.arrivals: Dict[int, dict] = {}    # chain -> snapshot
        self.result: Optional[dict] = None
        self.contributors: list = []
        self.degraded: list = []
        self.published = False


class FleetAggregator:
    """The fleet-wide weight-aggregation barrier (coordinator-local: every
    chain coordinator runs in or talks to this process, so the barrier is
    a condition variable, not a wire protocol — the WIRE cost of a round
    is the per-chain global replication + install that bracket it, both of
    which ride existing message kinds; see docs/protocol.md §9).

    Contract with ``live.Coordinator`` (one call per round per chain):

        result = aggregator.aggregate(chain_id, b0, snap)

    ``snap`` = {layer -> packed flat f32} covering the full model. Blocks
    until every LIVE chain arrives at round ``b0`` or ``barrier_timeout``
    lapses (then the no-shows are degraded out of the live set). Returns
    the fleet-mean {layer -> buffer} to install, or ``None`` when there is
    nothing to install (solo round — the caller IS the mean — or the
    barrier is closed). The mean is computed even for solo rounds: it
    seeds re-admitted chains (``latest_round``).

    Liveness transitions are explicit: ``chain_dead`` (collapse),
    ``chain_done`` (clean finish), ``chain_alive`` (re-admission) — plus
    the implicit re-admission of any degraded chain that shows up at a
    later round."""

    def __init__(self, num_chains: int, barrier_timeout: float = 60.0,
                 keep_rounds: int = 8):
        self.num_chains = num_chains
        self.barrier_timeout = barrier_timeout
        self.keep_rounds = keep_rounds
        self._cond = threading.Condition()
        self._live = set(range(num_chains))
        self._rounds: Dict[int, _Round] = {}
        self._order: list = []            # round batches, oldest first
        self._latest: Optional[tuple] = None    # (b0, result dict)
        self.closed = False
        self.rounds: list = []            # [{batch, contributors, degraded}]
        self.events: list = []            # [(t_wall, str)]
        self._t0 = time.monotonic()

    # ------------------------------ events -------------------------------

    def _log(self, text: str) -> None:
        self.events.append((time.monotonic() - self._t0, text))

    def live_chains(self) -> list:
        with self._cond:
            return sorted(self._live)

    def latest_round(self) -> Optional[tuple]:
        """(batch, {layer -> packed mean}) of the newest published round —
        the seed a re-admitted chain restarts from."""
        with self._cond:
            return self._latest

    def status(self) -> dict:
        with self._cond:
            return {"live": sorted(self._live),
                    "rounds": len(self.rounds),
                    "last_round": dict(self.rounds[-1]) if self.rounds
                    else None}

    # --------------------------- membership ------------------------------

    def _drop(self, chain_id: int, why: str) -> None:
        with self._cond:
            if chain_id in self._live:
                self._live.discard(chain_id)
                self._log(f"chain {chain_id} left the fleet ({why}); "
                          f"live={sorted(self._live)}")
            self._cond.notify_all()

    def chain_dead(self, chain_id: int) -> None:
        """Called by a collapsing chain (``ChainCollapsedError`` path) so
        in-flight rounds stop waiting for it."""
        self._drop(chain_id, "collapsed")

    def chain_done(self, chain_id: int) -> None:
        """A chain finished its batch budget cleanly — later rounds of
        slower chains must not wait out the timeout for it."""
        self._drop(chain_id, "finished")

    def chain_alive(self, chain_id: int) -> None:
        """(Re-)admit a chain into the live set — called by the fleet
        monitor right before relaunching a collapsed chain."""
        with self._cond:
            if chain_id not in self._live:
                self._live.add(chain_id)
                self._log(f"chain {chain_id} re-admitted; "
                          f"live={sorted(self._live)}")
            self._cond.notify_all()

    def close(self) -> None:
        """Unblock every waiter with ``None`` (fleet teardown)."""
        with self._cond:
            self.closed = True
            self._cond.notify_all()

    # ----------------------------- the barrier ---------------------------

    def aggregate(self, chain_id: int, b0: int,
                  snap: Dict[int, Any]) -> Optional[dict]:
        with self._cond:
            if self.closed:
                return None
            if chain_id not in self._live:
                # a degraded (slow, not dead) chain showed up again: it is
                # evidently alive — wait for it from the NEXT round on
                self._live.add(chain_id)
                self._log(f"chain {chain_id} rejoined at round {b0}; "
                          f"live={sorted(self._live)}")
            r = self._rounds.get(b0)
            if r is None:
                r = self._rounds[b0] = _Round(time.monotonic())
                self._order.append(b0)
                while len(self._order) > self.keep_rounds:
                    self._rounds.pop(self._order.pop(0), None)
            r.arrivals[chain_id] = snap
            self._cond.notify_all()
            while not r.published:
                if self.closed:
                    return None
                ready, degraded = protocol.aggregation_ready(
                    self._live, r.arrivals,
                    time.monotonic() - r.t0, self.barrier_timeout)
                if ready:
                    self._publish(b0, r, degraded)
                    break
                self._cond.wait(timeout=0.05)
            if r.contributors == [chain_id]:
                return None               # solo round: caller IS the mean
            return r.result

    def _publish(self, b0: int, r: _Round, degraded) -> None:
        """Compute and publish one round's mean. Caller holds the lock."""
        for d in sorted(degraded):
            self._live.discard(d)
        r.contributors = sorted(r.arrivals)
        r.degraded = sorted(degraded)
        r.result = fleet_average([r.arrivals[c] for c in r.contributors])
        r.published = True
        self._latest = (b0, r.result)
        self.rounds.append({"batch": int(b0),
                            "contributors": r.contributors,
                            "degraded": r.degraded})
        self._log(f"round b={b0}: aggregated {r.contributors}"
                  + (f", degraded {r.degraded}" if r.degraded else ""))
        self._cond.notify_all()


# ============================ fleet results ==============================


@dataclasses.dataclass
class FleetResult:
    chains: dict                      # chain_id -> LiveResult | None (a
    #   chain whose final incarnation collapsed/errored has None)
    chain_errors: dict                # chain_id -> str (final-incarnation
    #   error, if any)
    rounds: list                      # aggregator round records
    events: list                      # fleet-level (t_wall, str)
    incarnations: dict                # chain_id -> launch count
    exitcodes: dict                   # chain_id -> {incarnation -> {dev ->
    #   exit code}} (TCP fleets; SIGKILLed workers report -9, and a
    #   re-admitted incarnation's clean exits do NOT erase the evidence)
    final_flats: Optional[dict] = None   # fleet mean of the surviving
    #   chains' finished models ({layer -> packed flat f32})

    @property
    def losses(self) -> np.ndarray:
        """[B] fleet loss curve: per-batch nanmean across chains (NaN where
        no chain committed that batch — e.g. before a re-admitted chain's
        start_batch)."""
        arrs = [res.losses for res in self.chains.values() if res is not None]
        assert arrs, "no chain produced a result"
        return np.nanmean(np.stack(arrs), axis=0)

    @property
    def final_loss(self) -> float:
        return float(self.losses[-1])


# =========================== fleet coordinator ===========================


class FleetCoordinator:
    """Launches M chains, runs the aggregation barrier between them, and
    supervises chain-level faults (degrade to M-1, re-admit relaunches).

    transport="queue": each chain is an in-process Coordinator + worker
    threads on its own queue transport. transport="tcp": each chain is a
    full ``net.run_tcp_training`` cluster — coordinator + worker 0 in a
    thread here, workers 1..N-1 as SIGKILL-able OS processes, with every
    chain's port map pre-allocated up front (concurrent free-port probing
    races)."""

    def __init__(self, spec, live_cfg, fleet: FleetConfig, *,
                 transport: str = "queue", host: str = "127.0.0.1",
                 run_dir: Optional[str] = None):
        assert transport in ("queue", "tcp"), transport
        self.spec = spec
        self.base_cfg = live_cfg
        self.fleet = fleet
        self.transport = transport
        self.host = host
        self.run_dir = run_dir if run_dir is not None else live_cfg.run_dir
        self.agg = FleetAggregator(fleet.chains,
                                   barrier_timeout=fleet.barrier_timeout)
        self.events: list = []
        self._t0 = time.monotonic()
        self._lock = threading.Lock()
        self._coords: Dict[int, Any] = {}       # chain -> live Coordinator
        self._threads: Dict[int, threading.Thread] = {}
        self._results: Dict[int, Any] = {cid: None
                                         for cid in range(fleet.chains)}
        self._errors: Dict[int, str] = {}
        self._exitcodes: Dict[int, dict] = {}
        self._incarnations: Dict[int, int] = {cid: 0
                                              for cid in range(fleet.chains)}
        self._done_q: "queue.Queue[tuple]" = queue.Queue()
        self._stop = threading.Event()
        if transport == "tcp":
            from repro_torch.runtime import net
            sizes = [self._chain_workers(cid) for cid in range(fleet.chains)]
            ports = iter(net.free_ports(host, sum(sizes)))  # all distinct
            self._addr_maps = {
                cid: net.cluster_addresses(
                    n, host, ports=[next(ports) for _ in range(n)])
                for cid, n in enumerate(sizes)}
        else:
            self._addr_maps = {}

    # ------------------------------ set-up -------------------------------

    def _log(self, text: str) -> None:
        self.events.append((time.monotonic() - self._t0, text))

    def _chain_workers(self, cid: int) -> int:
        if self.fleet.chain_devices is not None:
            return len(self.fleet.chain_devices[cid])
        return self.base_cfg.num_workers

    def _chain_cfg(self, cid: int, start_batch: int = 0):
        """This chain's LiveConfig: the shared base, specialized."""
        from repro_torch.runtime.devices import DeviceSpec
        cfg = self.base_cfg
        kw = dict(
            protocol=dataclasses.replace(
                cfg.protocol, fleet_every=self.fleet.aggregate_every),
            min_workers=self.fleet.min_chain_workers,
            collect_final=True,
            start_batch=start_batch,
            kill_all_at=None,
        )
        if self.fleet.chain_devices is not None:
            caps = self.fleet.chain_devices[cid]
            kw["num_workers"] = len(caps)
            kw["device_specs"] = [
                DeviceSpec(f"chain{cid}-dev{i}", capacity=c)
                for i, c in enumerate(caps)]
            kw["bandwidth"] = None      # re-derived for the chain's size
        if (self.fleet.kill_chain is not None
                and self.fleet.kill_chain[0] == cid
                and self._incarnations[cid] == 0):
            kw["kill_all_at"] = self.fleet.kill_chain[1]
        if self.run_dir is not None:
            kw["run_dir"] = os.path.join(self.run_dir, f"chain{cid}")
            os.makedirs(kw["run_dir"], exist_ok=True)
        return dataclasses.replace(cfg, **kw)

    def _chain_spec(self, cid: int):
        """This chain's workload: shard cid of M (identical model init)."""
        if self.fleet.chains == 1:
            return self.spec
        return self.spec.shard(cid, self.fleet.chains)

    # ------------------------------ runners ------------------------------

    def _launch(self, cid: int, start_batch: int = 0,
                init_flats: Optional[dict] = None) -> None:
        cfg = self._chain_cfg(cid, start_batch=start_batch)
        self._incarnations[cid] += 1
        t = threading.Thread(
            target=self._run_chain, args=(cid, cfg, init_flats),
            daemon=True, name=f"fleet-chain-{cid}")
        self._threads[cid] = t
        t.start()

    def _run_chain(self, cid: int, cfg, init_flats: Optional[dict]) -> None:
        from repro_torch.runtime.live import ChainCollapsedError
        inc = self._incarnations[cid]
        try:
            if self.transport == "queue":
                res = self._run_chain_queue(cid, cfg, init_flats)
            else:
                res = self._run_chain_tcp(cid, cfg, init_flats)
        except ChainCollapsedError as err:
            with self._lock:
                self._errors[cid] = str(err)
                if err.worker_exitcodes:
                    self._exitcodes.setdefault(cid, {})[inc] = \
                        dict(err.worker_exitcodes)
            self._done_q.put((cid, "collapsed", err))
            return
        except Exception as err:          # noqa: BLE001 — chain post-mortem
            with self._lock:
                self._errors[cid] = f"{type(err).__name__}: {err}"
            self.agg.chain_dead(cid)
            self._done_q.put((cid, "error", err))
            return
        with self._lock:
            self._results[cid] = res
            self._errors.pop(cid, None)
            if res.worker_exitcodes:
                self._exitcodes.setdefault(cid, {})[inc] = \
                    dict(res.worker_exitcodes)
        self.agg.chain_done(cid)
        self._done_q.put((cid, "ok", res))

    def _chain_manifest(self, cid: int, cfg) -> Optional[dict]:
        """A SINGLE-CHAIN RunConfig doc for this chain's own run manifest
        (under run_dir/chain<i>), so ``Run.resume`` can relaunch the chain
        standalone with the existing durable machinery — fleet-level
        resume is a separate, future concern (``FleetManifest``)."""
        if cfg.run_dir is None:
            return None
        from repro_torch.run import RunConfig
        return RunConfig(workload=self._chain_spec(cid), live=cfg,
                         transport=self.transport,
                         host=self.host).to_manifest()

    def _run_chain_queue(self, cid: int, cfg, init_flats):
        from repro_torch.runtime.live import Coordinator
        chain, batches = self._chain_spec(cid).build(device=cfg.device)
        coord = Coordinator(chain, lambda gb: batches[gb % len(batches)],
                            cfg, aggregator=self.agg, chain_id=cid,
                            init_flats=init_flats,
                            manifest_doc=self._chain_manifest(cid, cfg))
        with self._lock:
            self._coords[cid] = coord
        return coord.run()

    def _run_chain_tcp(self, cid: int, cfg, init_flats):
        from repro_torch.runtime import net

        def grab(coord):
            with self._lock:
                self._coords[cid] = coord

        return net.run_tcp_training(
            self._chain_spec(cid), cfg, host=self.host,
            aggregator=self.agg, chain_id=cid, init_flats=init_flats,
            addr_of=dict(self._addr_maps[cid]), on_coordinator=grab,
            manifest_doc=self._chain_manifest(cid, cfg))

    # ----------------------------- supervision ---------------------------

    def run(self) -> FleetResult:
        M = self.fleet.chains
        self._log(f"fleet start: {M} chain(s) x "
                  f"{self._chain_workers(0)} workers, aggregate every "
                  f"{self.fleet.aggregate_every} batches "
                  f"({self.transport} transport)")
        self._write_manifest("running")
        for cid in range(M):
            self._launch(cid)
        pending_readmit: Dict[int, int] = {}     # chain -> rounds seen at
        #                                          collapse time
        active = set(range(M))
        while active:
            try:
                cid, outcome, _info = self._done_q.get(timeout=0.5)
            except queue.Empty:
                self._maybe_readmit(pending_readmit, active)
                continue
            active.discard(cid)
            if outcome == "ok":
                self._log(f"chain {cid} finished "
                          f"(incarnation {self._incarnations[cid]})")
            else:
                self._log(f"chain {cid} {outcome}: "
                          f"{self._errors.get(cid, '?')}; fleet degrades "
                          f"to {sorted(self.agg.live_chains())}")
                if (outcome == "collapsed" and self.fleet.readmit
                        and not self._stop.is_set()):
                    pending_readmit[cid] = len(self.agg.rounds)
                    self._log(f"chain {cid} queued for re-admission after "
                              f"the next published round")
            self._maybe_readmit(pending_readmit, active, none_active=(
                not active))
        self.agg.close()
        return self._finish()

    def _maybe_readmit(self, pending: Dict[int, int], active: set,
                       none_active: bool = False) -> None:
        """Relaunch collapsed chains once a round published WITHOUT them
        (proof the fleet moved on + a fresh mean to seed from). If no
        chain is left running, don't wait for a round that cannot come —
        seed from the latest mean (or init) immediately."""
        if self._stop.is_set():
            pending.clear()
            return
        for cid in sorted(pending):
            seen = pending[cid]
            if len(self.agg.rounds) <= seen and not none_active:
                continue
            latest = self.agg.latest_round()
            start, seed = (latest if latest is not None else (0, None))
            del pending[cid]
            self.agg.chain_alive(cid)
            self._log(f"re-admitting chain {cid} (incarnation "
                      f"{self._incarnations[cid] + 1}) from round "
                      f"b={start}" + ("" if seed is not None
                                      else " (no published round: init)"))
            active.add(cid)
            self._launch(cid, start_batch=start, init_flats=seed)
            self._write_manifest("running")

    def _finish(self) -> FleetResult:
        res = FleetResult(
            chains=dict(self._results),
            chain_errors=dict(self._errors),
            rounds=list(self.agg.rounds),
            events=list(self.events) + list(self.agg.events),
            incarnations=dict(self._incarnations),
            exitcodes=dict(self._exitcodes),
        )
        finals = [r.final_flats for r in self._results.values()
                  if r is not None and r.final_flats]
        if finals:
            res.final_flats = fleet_average(finals)
        self._log("fleet done: rounds="
                  f"{[rec['batch'] for rec in res.rounds]}")
        res.events = list(self.events) + list(self.agg.events)
        self._write_manifest("finished")
        return res

    # ----------------------------- control -------------------------------

    def request_stop(self) -> None:
        """Wind the whole fleet down at the next batch boundary."""
        self._stop.set()
        with self._lock:
            coords = dict(self._coords)
        for coord in coords.values():
            coord.request_stop()
        self.agg.close()

    def status(self) -> dict:
        """The nested fleet/chains schema ``Run.status()`` re-exports."""
        with self._lock:
            coords = dict(self._coords)
        chains = {}
        for cid in range(self.fleet.chains):
            coord = coords.get(cid)
            if coord is not None:
                chains[cid] = coord.chain_status()
        return {"fleet": {"chains": self.fleet.chains,
                          "live": self.agg.live_chains(),
                          "aggregate_every": self.fleet.aggregate_every,
                          "rounds": len(self.agg.rounds),
                          "incarnations": dict(self._incarnations)},
                "chains": chains}

    # ----------------------------- durability ----------------------------

    def _write_manifest(self, state: str) -> None:
        if self.run_dir is None:
            return
        from repro_torch.checkpoint.manifest import FleetManifest
        FleetManifest(config=self.fleet.to_doc(),
                      state={"state": state,
                             "live": self.agg.live_chains(),
                             "rounds": list(self.agg.rounds),
                             "incarnations": dict(self._incarnations),
                             "transport": self.transport},
                      ).write(self.run_dir)
