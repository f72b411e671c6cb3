"""The public run facade: one way to construct, launch, and resume runs.

Every entry point — ``launch/live_train.py``, the examples, tests, the
failover demo — builds a :class:`RunConfig` (workload spec + live/protocol
settings + transport choice) and drives it through a :class:`Run` handle.
Nobody outside this module wires a ``LiveConfig`` to a transport by hand
anymore; the facade owns the mapping from config to cluster shape:

* ``transport="queue"`` — in-process cluster (threads + queue
  ``Transport``), the CI-friendly default;
* ``transport="tcp"``   — real OS processes over ``SocketTransport``
  (``runtime/net.py``), one per worker device.

A config with ``live.run_dir`` set is DURABLE: the coordinator mirrors
global replicas to disk and atomically rewrites a run manifest at every
global replication point (docs/protocol.md §8). ``Run.resume(run_dir)``
rebuilds the config from that manifest and relaunches from the last
committed batch — including after a coordinator SIGKILL, re-adopting
surviving worker processes through the abort+install handshake.

The torch device of the run (``LiveConfig.device``: CUDA unless the caller
passes ``"cpu"``) is part of the config and of the manifest, so a resumed
run computes where the first one did.
"""
from __future__ import annotations

import dataclasses
import threading
from typing import Optional

from repro_torch.checkpoint.manifest import RunManifest
from repro_torch.runtime import protocol as protocol_mod
from repro_torch.runtime.fleet import FleetConfig
from repro_torch.runtime.live import (COORD, Coordinator, LiveConfig,
                                      LiveResult)
from repro_torch.runtime.workload import WorkloadSpec

# LiveConfig fields that do NOT round-trip through the manifest: runtime
# objects (profile, device_specs, bandwidth), fault injection (fault,
# kill, kill_all_at, rejoin, join_after, netem — a resumed run must not
# replay the crash schedule or the emulated network that produced the
# manifest), and the resume coordinates themselves (run_dir/start_batch/
# resume are assigned by Run.resume, never persisted). ``device`` is
# persisted.
_LIVE_SKIP = frozenset({
    "protocol", "profile", "device_specs", "bandwidth", "fault", "kill",
    "rejoin", "join_after", "run_dir", "start_batch", "resume", "netem",
    "kill_all_at",
})


def _live_to_doc(live: LiveConfig) -> dict:
    doc = {f.name: getattr(live, f.name)
           for f in dataclasses.fields(live) if f.name not in _LIVE_SKIP}
    doc["protocol"] = dataclasses.asdict(live.protocol)
    return doc


def _live_from_doc(doc: dict) -> LiveConfig:
    doc = dict(doc)
    proto = protocol_mod.ProtocolConfig(**doc.pop("protocol", {}))
    known = {f.name for f in dataclasses.fields(LiveConfig)}
    return LiveConfig(protocol=proto,
                      **{k: v for k, v in doc.items() if k in known})


# One row per CLI flag: argparse dest -> (config group, config field,
# fallback default for partial namespaces). This TABLE is the whole
# CLI-to-config mapping — adding a flag is one argparse line in
# launch/live_train.py plus one row here (tests/test_torch_run.py guards
# the two against drifting apart). Flags that need more than a rename are
# finished in the explicit fixup pass inside ``from_args`` below.
_ARG_MAP = {
    # ---- workload (WorkloadSpec) ----------------------------------------
    "chain":                ("workload", "kind", "mlp"),
    "seed":                 ("workload", "seed", 0),
    "layers":               ("workload", "num_layers", 8),
    "batch_size":           ("workload", "batch_size", 16),
    "data_batches":         ("workload", "num_data_batches", None),
    # ---- protocol (ProtocolConfig) --------------------------------------
    "chain_every":          ("protocol", "chain_every", 10),
    "global_every":         ("protocol", "global_every", 20),
    "repartition_first_at": ("protocol", "repartition_first_at", 5),
    "repartition_every":    ("protocol", "repartition_every", 15),
    "detect_timeout":       ("protocol", "detect_timeout", 0.5),
    "refit_hysteresis":     ("protocol", "refit_hysteresis", None),
    # ---- live (LiveConfig) ----------------------------------------------
    "workers":              ("live", "num_workers", 3),
    "batches":              ("live", "num_batches", 40),
    "lr":                   ("live", "lr", 0.1),
    "momentum":             ("live", "momentum", 0.0),
    "aggregate_every":      ("live", "aggregate_every", 0),
    "capacity_source":      ("live", "capacity_source", "measured"),
    "emulate":              ("live", "emulate_capacity", False),
    "uncompiled":           ("live", "compiled", False),   # inverted below
    "wire_codec":           ("live", "wire_codec", False),
    "wire_compress":        ("live", "wire_compress", "off"),
    "wire_compress_replica": ("live", "wire_compress_replica", None),
    "join_wait":            ("live", "join_wait", 20.0),
    "reliable_wire":        ("live", "reliable_data", False),
    "run_dir":              ("live", "run_dir", None),
    "capacity_ema":         ("live", "capacity_ema", 0.0),
    "static_partition":     ("live", "static_partition", False),
    "overlap_replication":  ("live", "overlap_replication", False),
    "repl_delta":           ("live", "repl_delta", "counters"),
    "netem":                ("live", "netem", None),       # parsed below
    "device":               ("live", "device", "cuda"),
    # ---- fleet (FleetConfig) --------------------------------------------
    "chains":               ("fleet", "chains", 1),
    "fleet_every":          ("fleet", "aggregate_every", 10),
    # ---- run (RunConfig itself) -----------------------------------------
    "transport":            ("run", "transport", "queue"),
    "host":                 ("run", "host", "127.0.0.1"),
}


@dataclasses.dataclass
class RunConfig:
    """Everything needed to launch (or relaunch) one training run.

    ``workload`` is the deterministic recipe every process rebuilds the
    model/data from (only tensors travel the wire); ``live`` carries the
    protocol + runtime knobs, including ``live.run_dir`` for durable
    runs; ``fleet`` adds the data axis (M replicated chains meeting at a
    periodic weight-aggregation barrier — ``runtime/fleet.py``; the
    default is a single chain, exactly the pre-fleet behavior);
    ``transport`` picks the cluster substrate."""

    workload: WorkloadSpec = dataclasses.field(default_factory=WorkloadSpec)
    live: LiveConfig = dataclasses.field(default_factory=LiveConfig)
    fleet: FleetConfig = dataclasses.field(default_factory=FleetConfig)
    transport: str = "queue"                    # "queue" | "tcp"
    host: str = "127.0.0.1"                     # tcp: bind/connect host

    def __post_init__(self):
        if self.transport not in ("queue", "tcp"):
            raise ValueError(f"unknown transport {self.transport!r}")

    # --------------------------- CLI binding -----------------------------

    @staticmethod
    def from_args(ns) -> "RunConfig":
        """Build from an argparse namespace (``launch/live_train.py``'s
        flag set, underscores for dashes) by walking ``_ARG_MAP``. Only
        attributes present on ``ns`` are consulted, so partial namespaces
        (tests, embedding CLIs) work; fallback defaults mirror the CLI's.
        Fault injection (--kill / --rejoin / --join-after) and per-host
        plumbing stay CLI-local — they are applied on top and never
        serialized to a manifest."""
        groups: dict = {"workload": {}, "protocol": {}, "live": {},
                        "fleet": {}, "run": {}}
        for dest, (group, field, default) in _ARG_MAP.items():
            groups[group][field] = getattr(ns, dest, default)
        # fixups — the few flags that are more than a rename:
        w = groups["workload"]
        if w.get("num_data_batches") is None:    # kind-dependent default
            w["num_data_batches"] = 8 if w["kind"] == "mlp" else 4
        lv = groups["live"]
        lv["compiled"] = not lv["compiled"]      # dest is --uncompiled
        if isinstance(lv.get("netem"), str):     # inline JSON or a path
            from repro_torch.runtime.netem import NetemSpec
            lv["netem"] = NetemSpec.from_json(lv["netem"])
        proto = protocol_mod.ProtocolConfig(**groups.pop("protocol"))
        return RunConfig(workload=WorkloadSpec(**w),
                         live=LiveConfig(protocol=proto, **lv),
                         fleet=FleetConfig(**groups["fleet"]),
                         **groups["run"])

    # ------------------------ manifest round-trip ------------------------

    def to_manifest(self) -> dict:
        """The plain-JSON ``config`` block of the run manifest — enough
        for ``from_manifest`` to rebuild an equivalent RunConfig in a
        fresh process. Block version 2 = fleet-aware (version 1 docs,
        written before the ``fleet`` block existed, still load — they
        mean a single-chain run)."""
        return {"version": 2,
                "workload": dataclasses.asdict(self.workload),
                "live": _live_to_doc(self.live),
                "fleet": self.fleet.to_doc(),
                "transport": self.transport,
                "host": self.host}

    @staticmethod
    def from_manifest(doc: dict) -> "RunConfig":
        version = int(doc.get("version", 1))
        if version not in (1, 2):
            raise ValueError(
                f"unsupported run-config version {version!r}")
        return RunConfig(
            workload=WorkloadSpec(**doc.get("workload", {})),
            live=_live_from_doc(doc.get("live", {})),
            fleet=FleetConfig.from_doc(doc.get("fleet")),
            transport=doc.get("transport", "queue"),
            host=doc.get("host", "127.0.0.1"))


class Run:
    """Handle on one training run: ``start()`` launches it on a daemon
    thread, ``wait()`` joins it, ``status()`` reports progress (reading
    the manifest for durable runs), ``stop()`` asks the coordinator to
    wind down cleanly at the next batch boundary.

    ``Run.resume(run_dir)`` is the relaunch entry: it loads the manifest,
    rebuilds the config, and returns a Run that starts from the last
    committed batch, re-adopting surviving remote workers (TCP runs)
    instead of spawning a cold cluster."""

    def __init__(self, config: RunConfig,
                 addr_of: Optional[dict] = None):
        """``addr_of`` (tcp only): attach to an EXISTING cluster at these
        node -> (host, port) addresses — multi-host ``--role coordinator``
        mode, where worker processes are started per-host by the operator
        — instead of spawning localhost worker processes."""
        self.config = config
        self.addr_of = addr_of
        self._thread: Optional[threading.Thread] = None
        self._coord: Optional[Coordinator] = None
        self._fleet = None               # FleetCoordinator (chains > 1)
        self._result = None              # LiveResult | FleetResult
        self._error: Optional[BaseException] = None
        self._resume_state: Optional[dict] = None
        self._stop_wanted = False
        self._lock = threading.Lock()

    # ------------------------------ resume -------------------------------

    @staticmethod
    def resume(run_dir: str, num_batches: Optional[int] = None) -> "Run":
        """Relaunch the run persisted under ``run_dir`` from its last
        committed batch. A manifest with ``last_committed = -1`` (crashed
        before the first global replication) resumes as a fresh start.
        ``num_batches`` overrides the recorded horizon (e.g. to extend a
        finished run)."""
        manifest = RunManifest.load(run_dir)
        config = RunConfig.from_manifest(manifest.config)
        start = manifest.last_committed + 1
        live = dataclasses.replace(
            config.live, run_dir=run_dir, resume=start > 0,
            start_batch=max(start, 0),
            num_batches=(num_batches if num_batches is not None
                         else int(manifest.state.get(
                             "num_batches", config.live.num_batches))))
        run = Run(dataclasses.replace(config, live=live))
        if start > 0:
            run._resume_state = dict(manifest.state)
        return run

    # ----------------------------- lifecycle -----------------------------

    def start(self) -> "Run":
        with self._lock:
            if self._thread is not None:
                raise RuntimeError("run already started")
            self._thread = threading.Thread(
                target=self._main, name="run-facade", daemon=True)
            self._thread.start()
        return self

    def wait(self, timeout: Optional[float] = None):
        """Join the run. Returns a ``LiveResult`` for single-chain runs,
        a ``fleet.FleetResult`` when ``config.fleet.chains > 1``."""
        if self._thread is None:
            raise RuntimeError("run not started")
        self._thread.join(timeout)
        if self._thread.is_alive():
            raise TimeoutError("run still in progress")
        if self._error is not None:
            raise self._error
        assert self._result is not None
        return self._result

    def stop(self) -> None:
        """Request a clean wind-down at the next batch boundary (durable
        runs keep their manifest; ``wait()`` still returns a result). Safe
        to call before the coordinator exists — the request is applied the
        moment the cluster wiring hands us one."""
        with self._lock:
            self._stop_wanted = True
            coord = self._coord
            fleet = self._fleet
        if fleet is not None:
            fleet.request_stop()
        elif coord is not None:
            coord.request_stop()

    def _attach(self, coord: Coordinator) -> None:
        with self._lock:
            self._coord = coord
            wanted = self._stop_wanted
        if wanted:
            coord.request_stop()

    def status(self) -> dict:
        """Progress snapshot, in the nested fleet/chains schema
        (docs/operations.md):

            {"state", "transport",
             "fleet":  {chains, live, rounds, aggregate_every, ...},
             "chains": {chain_id: {"progress", "wire", "membership"}}}

        A single-chain run is reported as a fleet of one (its chain id is
        0). For durable runs the manifest's last committed batch rides in
        ``chains[i]["progress"]["last_committed_manifest"]`` (readable by
        ANY process, not just the owning one).

        DEPRECATED top-level aliases — ``batches_done``, ``wire``,
        ``last_committed`` — mirror chain 0 / the fleet max for one
        release; read the nested schema instead."""
        if self._thread is None:
            state = "created"
        elif self._thread.is_alive():
            state = "running"
        else:
            state = "failed" if self._error is not None else "finished"
        with self._lock:
            coord, fleet = self._coord, self._fleet
        out = {"state": state, "transport": self.config.transport}
        if fleet is not None:
            snap = fleet.status()
        elif coord is not None:
            snap = {"fleet": {"chains": 1, "live": [0],
                              "aggregate_every": 0, "rounds": 0,
                              "incarnations": {0: 1}},
                    "chains": {0: coord.chain_status()}}
        else:
            snap = {"fleet": {"chains": self.config.fleet.chains,
                              "live": [], "rounds": 0,
                              "aggregate_every":
                              self.config.fleet.aggregate_every,
                              "incarnations": {}},
                    "chains": {}}
        out["fleet"] = snap["fleet"]
        out["chains"] = snap["chains"]
        run_dir = self.config.live.run_dir
        if run_dir and self.config.fleet.chains == 1:
            manifest = RunManifest.try_load(run_dir)
            if 0 in out["chains"]:
                out["chains"][0]["progress"]["last_committed_manifest"] = (
                    manifest.last_committed if manifest is not None else -1)
        # ---- deprecated flat aliases (one release; docs/operations.md) --
        out["batches_done"] = max(
            (c["progress"]["batches_done"] for c in out["chains"].values()),
            default=0)
        wire0 = out["chains"].get(0, {}).get("wire")
        if wire0 is not None:
            out["wire"] = {"bytes": wire0.get("bytes", 0),
                           "kind_bytes": dict(wire0.get("kind_bytes", {})),
                           "kind_msgs": dict(wire0.get("kind_msgs", {}))}
        if run_dir and self.config.fleet.chains == 1:
            manifest = RunManifest.try_load(run_dir)
            out["last_committed"] = (manifest.last_committed
                                     if manifest is not None else -1)
        if self._error is not None:
            out["error"] = repr(self._error)
        return out

    # --------------------------- cluster wiring --------------------------

    def _main(self) -> None:
        try:
            self._result = self._run_impl()
        except BaseException as exc:          # surfaced by wait()
            self._error = exc

    def _run_impl(self):
        cfg = self.config
        if cfg.fleet.chains > 1:
            if self._resume_state is not None:
                raise RuntimeError(
                    "fleet resume is not supported yet — resume each "
                    "chain's run_dir/chain<i> individually")
            if self.addr_of is not None:
                raise RuntimeError(
                    "fleet runs manage their own clusters; --role "
                    "attachment is single-chain only")
            return self._run_fleet(cfg)
        if cfg.transport == "queue":
            return self._run_queue(cfg)
        if self._resume_state is not None:
            return self._run_tcp_resume(cfg)
        if self.addr_of is not None:
            return self._run_tcp_attached(cfg, self.addr_of)
        return self._run_tcp_fresh(cfg)

    def _run_fleet(self, cfg: RunConfig):
        from repro_torch.runtime.fleet import FleetCoordinator
        fc = FleetCoordinator(cfg.workload, cfg.live, cfg.fleet,
                              transport=cfg.transport, host=cfg.host,
                              run_dir=cfg.live.run_dir)
        with self._lock:
            self._fleet = fc
            wanted = self._stop_wanted
        if wanted:
            fc.request_stop()
        return fc.run()

    def _run_queue(self, cfg: RunConfig) -> LiveResult:
        chain, batches = cfg.workload.build(device=cfg.live.device)
        coord = Coordinator(chain, lambda b: batches[b % len(batches)],
                            cfg.live, manifest_doc=cfg.to_manifest(),
                            resume_state=self._resume_state)
        self._attach(coord)
        return coord.run()

    def _run_tcp_fresh(self, cfg: RunConfig) -> LiveResult:
        from repro_torch.runtime import net

        def grab(coord):
            self._attach(coord)

        return net.run_tcp_training(cfg.workload, cfg.live, host=cfg.host,
                                    manifest_doc=cfg.to_manifest(),
                                    on_coordinator=grab)

    def _run_tcp_attached(self, cfg: RunConfig, addr_of: dict) -> LiveResult:
        """Coordinator attached to operator-managed worker processes
        (multi-host clusters): bind our address from ``addr_of``, expect
        every other device to announce itself."""
        from repro_torch.runtime.net import SocketTransport

        chain, batches = cfg.workload.build(device=cfg.live.device)
        transport = SocketTransport(addr_of, local=(COORD, 0),
                                    fault=cfg.live.fault,
                                    policy=cfg.live.wire_policy(),
                                    reliable=cfg.live.reliable_data,
                                    rto=cfg.live.rto,
                                    netem=cfg.live.netem)
        coord = Coordinator(chain, lambda b: batches[b % len(batches)],
                            cfg.live, transport=transport,
                            remote_devs={d for d in addr_of if d > 0},
                            manifest_doc=cfg.to_manifest())
        self._attach(coord)
        try:
            res = coord.run()
            transport.flush()      # the workers' stop, before the close
            return res
        finally:
            transport.close()

    def _run_tcp_resume(self, cfg: RunConfig) -> LiveResult:
        """Relaunched TCP coordinator: rebind the manifest's recorded
        coordinator address, re-adopt surviving worker PROCESSES (they
        were never ours to spawn — they outlived the old coordinator),
        and train the remaining batches. Workers that died with the old
        coordinator are dropped from the partition at bring-up."""
        from repro_torch.runtime.net import SocketTransport

        state = self._resume_state or {}
        addr_of = {int(n): (a[0], int(a[1]))
                   for n, a in state.get("addr_of", {}).items()}
        if COORD not in addr_of:
            raise RuntimeError("manifest has no coordinator address — "
                               "was this a queue run?")
        chain, batches = cfg.workload.build(device=cfg.live.device)
        transport = SocketTransport(addr_of, local=(COORD, 0),
                                    policy=cfg.live.wire_policy(),
                                    reliable=cfg.live.reliable_data,
                                    rto=cfg.live.rto,
                                    netem=cfg.live.netem)
        remote = {int(d) for d in state.get("worker_ids", []) if int(d) > 0}
        coord = Coordinator(chain, lambda b: batches[b % len(batches)],
                            cfg.live, transport=transport,
                            remote_devs=remote,
                            manifest_doc=cfg.to_manifest(),
                            resume_state=state)
        self._attach(coord)
        try:
            res = coord.run()
            transport.flush()      # the workers' stop, before the close
            return res
        finally:
            transport.close()


def start_run(config: RunConfig) -> Run:
    """Convenience: ``Run(config).start()``."""
    return Run(config).start()
