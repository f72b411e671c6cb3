"""Live multi-worker FTPipeHD training entry point of the PyTorch port
(runtime/live.py + net.py).

Trains a real layer chain under the full protocol — 1F1B with
vertical-sync weight versions, chain/global replication, dynamic
re-partition, and (optionally) a mid-run worker kill with §III-F recovery
— over either transport:

  * ``--transport queue`` (default): coordinator + N worker THREADS in one
    process over the fault-injectable in-memory transport;
  * ``--transport tcp``: coordinator + N-1 worker PROCESSES over
    length-prefixed TCP sockets (``runtime/net.py``); a ``--kill`` here
    SIGKILLs a real process. Without ``--role`` the entry point spawns the
    whole localhost cluster itself (tests/CI); with ``--role`` it runs ONE
    process, for real multi-host clusters — start the same command on
    every host, varying only ``--role``/``--dev``/``--listen``.

Every process computes on ``--device`` (default ``cuda``; each worker
process opens its own CUDA context). Without a GPU the entry point exits
non-zero unless it is given ``--device cpu``: it never falls back to the
CPU on its own.

Examples:
  PYTHONPATH=src python -m repro_torch.launch.live_train --chain mlp \
      --batches 40
  PYTHONPATH=src python -m repro_torch.launch.live_train --chain mobilenet \
      --workers 3 --batches 30 --kill 1@12
  PYTHONPATH=src python -m repro_torch.launch.live_train --transport tcp \
      --batches 30 --kill 1@12
  PYTHONPATH=src python -m repro_torch.launch.live_train --device cpu \
      --transport tcp --batches 12 --kill 1@6
  # multi-host (one line per host; 'coord' covers COORD + worker 0):
  PYTHONPATH=src python -m repro_torch.launch.live_train --transport tcp \
      --role coordinator --listen 0.0.0.0:9000 \
      --peers coord=10.0.0.1:9000,1=10.0.0.2:9001,2=10.0.0.3:9002
  PYTHONPATH=src python -m repro_torch.launch.live_train --transport tcp \
      --role worker --dev 1 --listen 0.0.0.0:9001 \
      --peers coord=10.0.0.1:9000,1=10.0.0.2:9001,2=10.0.0.3:9002
"""
import argparse
import sys


def build_parser() -> argparse.ArgumentParser:
    """The CLI surface (``run._ARG_MAP`` maps its flags onto the run
    config)."""
    ap = argparse.ArgumentParser(
        description="Live FTPipeHD training over queue or TCP transport")
    ap.add_argument("--chain", default="mlp", choices=["mlp", "mobilenet"])
    ap.add_argument("--workers", type=int, default=3)
    ap.add_argument("--batches", type=int, default=40)
    ap.add_argument("--batch-size", type=int, default=16)
    ap.add_argument("--lr", type=float, default=0.1)
    ap.add_argument("--momentum", type=float, default=0.0)
    ap.add_argument("--layers", type=int, default=8,
                    help="mlp chain depth (mobilenet is fixed at 19)")
    ap.add_argument("--data-batches", type=int, default=None,
                    help="distinct data batches to cycle over (default: "
                         "8 for mlp, 4 for mobilenet)")
    ap.add_argument("--kill", default=None, metavar="DEV@BATCH",
                    help="crash worker DEV when BATCH commits, e.g. 1@12 "
                         "(a real SIGKILL under --transport tcp)")
    ap.add_argument("--rejoin", default=None, metavar="DEV@BATCH",
                    help="relaunch the previously-killed worker DEV when "
                         "BATCH commits; it rejoins with a bumped "
                         "incarnation and the pipeline expands back "
                         "(pair with --kill, e.g. --kill 1@10 "
                         "--rejoin 1@16)")
    ap.add_argument("--join-after", type=int, default=None, metavar="BATCH",
                    help="hot-join a NEW device (id = --workers) when "
                         "BATCH commits, growing the pipeline beyond the "
                         "launch set")
    ap.add_argument("--join-wait", type=float, default=20.0,
                    help="max seconds the coordinator waits at a control "
                         "point for a scheduled joiner's hello")
    ap.add_argument("--incarnation", type=int, default=0,
                    help="tcp --role worker: this process's incarnation — "
                         "relaunch a dead worker by re-running its exact "
                         "command with this bumped (the coordinator fences "
                         "stale incarnations and admits the new one)")
    ap.add_argument("--capacities", default=None,
                    help="comma list of per-device capacities (C_i)")
    ap.add_argument("--emulate", action="store_true",
                    help="sleep-scale compute per --capacities")
    ap.add_argument("--capacity-source", default="measured",
                    choices=["measured", "spec"])
    ap.add_argument("--chain-every", type=int, default=10)
    ap.add_argument("--global-every", type=int, default=20)
    ap.add_argument("--repartition-first-at", type=int, default=5,
                    help="batch of the first capacity-driven re-partition "
                         "check (then every --repartition-every)")
    ap.add_argument("--repartition-every", type=int, default=15)
    ap.add_argument("--detect-timeout", type=float, default=0.5)
    ap.add_argument("--aggregate-every", type=int, default=0)
    ap.add_argument("--chains", type=int, default=1,
                    help="data-parallel fleet: train M replicated pipeline "
                         "chains on disjoint shards of the batch stream, "
                         "meeting every --fleet-every batches at a weight-"
                         "aggregation barrier (runtime/fleet.py); 1 = the "
                         "classic single-chain run")
    ap.add_argument("--fleet-every", type=int, default=10,
                    help="fleet aggregation period K: every K committed "
                         "batches each chain contributes its packed per-"
                         "layer weights and installs the fleet mean "
                         "(only meaningful with --chains > 1)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--uncompiled", action="store_true",
                    help="per-layer autograd + sgd_update reference hot "
                         "path (the fused StageExecutor step with the "
                         "fused_sgd kernel is the default)")
    ap.add_argument("--wire-codec", action="store_true",
                    help="queue transport only: round-trip every payload "
                         "through the bytes wire format (runtime/codec.py); "
                         "TCP always does")
    ap.add_argument("--wire-compress", default="off",
                    choices=["off", "fp16", "int8", "int8-fused"],
                    help="data-plane wire tier: quantize act/grad tensors "
                         "(fp16 cast, or int8 per-tensor affine ~3.9x "
                         "smaller); int8-fused quantizes on the device "
                         "at the stage boundary (kernels/quant, per-"
                         "channel + error-feedback residuals) and ships "
                         "the codes zero-copy. Decode is self-describing and "
                         "ineligible tensors fall back to exact f32. "
                         "Implies --wire-codec on the queue transport")
    ap.add_argument("--wire-compress-replica", default=None,
                    choices=["off", "fp16", "int8"],
                    help="tier for the periodic §III-E replica snapshots "
                         "(chain_put/global_put); default: follow "
                         "--wire-compress. §III-F redistribution payloads "
                         "are always exact f32 regardless")
    ap.add_argument("--overlap-replication", action="store_true",
                    help="overlap-everything scheduler: §III-E replica "
                         "shipments (and admission capacity probes) leave "
                         "the control point as a snapshot + immediate ack "
                         "and the bytes ride the NEXT segment's compute; "
                         "seeding and barrier rounds still drain "
                         "(docs/protocol.md §10). Off = drain mode, the "
                         "control arm of the WAN bench")
    ap.add_argument("--repl-delta", default="counters",
                    choices=["counters", "bytes"],
                    help="§III-E delta-skip detector: 'counters' uses the "
                         "StageExecutor's O(1) per-layer change counters; "
                         "'bytes' keeps the legacy per-layer byte compare "
                         "against shadow copies")
    ap.add_argument("--netem", default=None, metavar="JSON|FILE",
                    help="WAN emulation: a NetemSpec as inline JSON or a "
                         "path to a JSON file (schema in docs/operations.md "
                         "§WAN emulation) shaping every link under the "
                         "transport — one-way latency + jitter, token-"
                         "bucket bandwidth, loss, timed partitions; works "
                         "under both --transport queue and tcp")
    ap.add_argument("--capacity-ema", type=float, default=0.0,
                    help="EWMA factor for capacity samples (0 = paper's "
                         "last-sample-wins; 0.6-0.8 smooths jittery WAN "
                         "measurements)")
    ap.add_argument("--refit-hysteresis", type=float, default=None,
                    metavar="H",
                    help="only adopt a re-partition when its predicted "
                         "saving over the next control interval exceeds "
                         "(1+H) x the redistribution cost (default: the "
                         "paper's rule — refit on any cut-point change)")
    ap.add_argument("--static-partition", action="store_true",
                    help="PipeDream static baseline: equal split at launch "
                         "and at every re-solve (the control arm the WAN "
                         "heterogeneity bench compares against)")
    ap.add_argument("--reliable-wire", action="store_true",
                    help="seq/ack retransmit window on the data plane: a "
                         "dropped act/grad frame costs a resend (~rto), "
                         "not a segment-timeout drain; cluster-wide")
    ap.add_argument("--run-dir", default=None, metavar="DIR",
                    help="durable control plane: mirror global replicas "
                         "to a disk tier under DIR and keep a resumable "
                         "run manifest there (docs/protocol.md \u00a78)")
    ap.add_argument("--resume", default=None, metavar="DIR",
                    help="relaunch the run persisted under DIR from its "
                         "last committed batch (re-adopting surviving "
                         "worker processes on tcp); other flags are "
                         "ignored \u2014 the manifest is the config")
    ap.add_argument("--transport", default="queue", choices=["queue", "tcp"],
                    help="queue = threads in one process; tcp = one OS "
                         "process per worker over runtime/net.py sockets")
    ap.add_argument("--host", default="127.0.0.1",
                    help="tcp without --role: bind/connect host for the "
                         "locally-spawned cluster")
    ap.add_argument("--role", default=None,
                    choices=["coordinator", "worker"],
                    help="tcp only: run ONE process of a multi-host "
                         "cluster (omit to spawn the whole cluster locally)")
    ap.add_argument("--dev", type=int, default=None,
                    help="tcp --role worker: this process's device id")
    ap.add_argument("--listen", default=None, metavar="HOST:PORT",
                    help="tcp with --role: address THIS process binds")
    ap.add_argument("--peers", default=None,
                    metavar="coord=H:P,1=H:P,...",
                    help="tcp with --role: every node's address; the "
                         "'coord' entry covers COORD and worker 0")
    ap.add_argument("--device", default="cuda",
                    help="torch device every process computes on (cuda "
                         "or cpu); without a GPU only --device cpu runs")
    return ap


def _parse_at(value):
    """'DEV@BATCH' -> (dev, batch) or None."""
    if not value:
        return None
    dev, b = value.split("@")
    return (int(dev), int(b))


def _build_run_config(args, specs, kill):
    """The CLI's single source of run configuration: the shared
    ``run.RunConfig.from_args`` core (the part a manifest serializes),
    plus the CLI-local extras — fault injection and device emulation —
    layered on via ``dataclasses.replace``."""
    import dataclasses

    from repro_torch.run import RunConfig
    cfg = RunConfig.from_args(args)
    live = dataclasses.replace(
        cfg.live, kill=kill, rejoin=_parse_at(args.rejoin),
        join_after=args.join_after, device_specs=specs)
    return dataclasses.replace(cfg, live=live)


def _report_fleet(res, args):
    """Fleet-run summary (``fleet.FleetResult``)."""
    import numpy as np
    print(f"live FTPipeHD fleet: {args.chains} chains x {args.workers} "
          f"workers, {args.batches} batches, chain={args.chain}, "
          f"transport={args.transport}, aggregate every "
          f"{args.fleet_every} batches")
    losses = [l for l in res.losses if np.isfinite(l)]
    print(f"  fleet loss: {losses[0]:.3f} -> {losses[-1]:.3f} "
          f"(median last 5: {np.median(losses[-5:]):.3f})")
    for rec in res.rounds:
        extra = (f", degraded {rec['degraded']}" if rec["degraded"] else "")
        print(f"  round @batch {rec['batch']:4d}: contributors "
              f"{rec['contributors']}{extra}")
    for t, e in sorted(res.events):
        print(f"  t={t:7.2f}s  {e}")
    print(f"  incarnations: {res.incarnations}")
    if res.chain_errors:
        print(f"  chain errors: {res.chain_errors}")
    if res.exitcodes:
        print(f"  worker exit codes by chain: {res.exitcodes} "
              f"(-9 = SIGKILLed)")


def _report(res, args):
    import numpy as np
    if getattr(args, "chains", 1) > 1:
        return _report_fleet(res, args)
    print(f"live FTPipeHD run: {args.workers} workers, {args.batches} "
          f"batches, chain={args.chain}, transport={args.transport}, "
          f"hot path={'eager' if args.uncompiled else 'compiled'}"
          f"{', wire codec on' if args.wire_codec else ''}"
          f"{f', wire compress {args.wire_compress}' if args.wire_compress != 'off' else ''}")
    # resumed runs NaN-pad the batches trained before the resume point
    losses = [l for l in res.losses if np.isfinite(l)]
    print(f"  loss: {losses[0]:.3f} -> {losses[-1]:.3f} "
          f"(median last 5: {np.median(losses[-5:]):.3f})")
    for t, e in res.events:
        print(f"  t={t:7.2f}s  {e}")
    print("  partitions:")
    for b, pts in res.partitions:
        counts = np.diff(np.concatenate([[-1], np.asarray(pts)]))
        print(f"    from batch {b:4d}: {tuple(int(c) for c in counts)}")
    print(f"  capacities (C_i): "
          f"{[round(float(c), 3) for c in res.capacities]}")
    for adm in res.admissions:
        print(f"  admitted devs {adm['devs']} (incarnations "
              f"{adm['incs']}) @batch {adm['batch']}")
    s = res.transport_stats
    by_class = ""
    if s.get("data_bytes") or s.get("replica_bytes"):
        by_class = (f" (data plane {s['data_bytes'] / 1e6:.2f} MB, "
                    f"replicas {s['replica_bytes'] / 1e6:.2f} MB)")
    print(f"  transport: {s['delivered']} delivered / {s['dropped']} "
          f"dropped / {s['to_dead']} to-dead, {s['bytes'] / 1e6:.2f} MB"
          f"{by_class}")
    if res.worker_exitcodes:
        print(f"  worker exit codes: {res.worker_exitcodes} "
              f"(-9 = SIGKILLed by fault injection)")
    if any(len(h) > 1 for h in res.exitcode_history.values()):
        print(f"  exit-code history (per incarnation): "
              f"{res.exitcode_history}")


def _require_device(device) -> None:
    """Exit non-zero, with the reason, when ``device`` is not available
    (CUDA asked for without a GPU): nothing falls back to the CPU."""
    from repro_torch.runtime.devices import resolve_device
    try:
        resolve_device(device)
    except RuntimeError as err:
        sys.exit(f"live_train: {err} (--device cpu)")


def main(argv=None):
    args = build_parser().parse_args(argv)

    from repro_torch.run import Run
    from repro_torch.runtime.devices import DeviceSpec

    if args.resume:
        # the manifest IS the config: everything else on the command line
        # is ignored except --batches as an explicit horizon override
        run = Run.resume(args.resume)
        _require_device(run.config.live.device)
        print(f"resuming run from {args.resume}: transport="
              f"{run.config.transport}, start batch "
              f"{run.config.live.start_batch}")
        res = run.start().wait()
        _report(res, argparse.Namespace(
            workers=run.config.live.num_workers,
            batches=run.config.live.num_batches,
            chain=run.config.workload.kind,
            transport=run.config.transport,
            uncompiled=not run.config.live.compiled,
            wire_codec=run.config.live.wire_codec,
            wire_compress=run.config.live.wire_compress))
        return

    _require_device(args.device)
    specs = None
    if args.capacities:
        caps = [float(c) for c in args.capacities.split(",")]
        assert len(caps) == args.workers, (caps, args.workers)
        specs = [DeviceSpec(f"dev-{i}", c) for i, c in enumerate(caps)]

    cfg = _build_run_config(args, specs, _parse_at(args.kill))
    assert args.chains == 1 or args.role is None, \
        "--chains > 1 spawns its own per-chain clusters; --role " \
        "(operator-managed processes) is single-chain only"

    if args.transport == "tcp" and args.role == "worker":
        # one process of a multi-host cluster: no coordinator facade here,
        # just the worker loop against the operator-provided addresses
        from repro_torch.runtime import net
        assert args.dev is not None and args.listen and args.peers, \
            "--role worker needs --dev, --listen and --peers"
        addr_of = net.parse_peers(args.peers)
        host, _, port = args.listen.rpartition(":")
        addr_of[args.dev] = (host, int(port))
        net.worker_main(args.dev, addr_of, cfg.workload, cfg.live,
                        incarnation=args.incarnation)
        return

    addr_of = None
    if args.transport == "tcp" and args.role == "coordinator":
        from repro_torch.runtime import net
        from repro_torch.runtime.live import COORD
        assert args.listen and args.peers, \
            "--role coordinator needs --listen and --peers"
        assert not (args.rejoin or args.join_after is not None), \
            "--rejoin/--join-after cannot spawn processes on OTHER " \
            "hosts: relaunch the worker's own command with " \
            "--incarnation bumped; the coordinator admits it " \
            "automatically"
        addr_of = net.parse_peers(args.peers)
        host, _, port = args.listen.rpartition(":")
        addr_of[COORD] = addr_of[0] = (host, int(port))

    res = Run(cfg, addr_of=addr_of).start().wait()
    _report(res, args)


if __name__ == "__main__":
    main()
