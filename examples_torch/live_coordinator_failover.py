"""COORDINATOR failover demo on the PyTorch port — the durable control
plane end to end.

The port of ``examples/live_coordinator_failover.py``. FTPipeHD's weak
point is its central coordinator: §III-F recovers from worker crashes,
but the node hosting the control plane (and worker 0) was a single point
of failure. This demo kills it — SIGKILL, mid-segment, no goodbye — and
brings the run back:

1. a coordinator PROCESS (``net.coordinator_main``) trains with a durable
   ``run_dir``: global replicas mirror to a disk tier and a run manifest
   is atomically rewritten at every global replication point;
2. two worker PROCESSES train under it — and OUTLIVE it;
3. once the manifest has committed a mid-run batch, the demo SIGKILLs the
   coordinator: sockets sever mid-stream, the workers wedge waiting on
   activations that will never come;
4. ``Run.resume(run_dir)`` relaunches the coordinator from the manifest
   (device included): it rebinds the recorded address, learns the
   survivors from their heartbeats, RE-ADOPTS them (abort + install of
   the last committed weights, resent until acked), and trains the
   remaining batches.

The demo verifies loss CONTINUITY: every batch the resumed run trains is
compared against an uninterrupted single-process reference — max
divergence must stay under 0.05 (the seam batch is legitimately not
bit-equal: an uninterrupted pipeline forwards it with vertically-synced
stale weights, a resumed one restarts from the committed snapshot). It
exits non-zero otherwise. Every process computes on ``--device``
(default ``cuda``); without a GPU the demo exits non-zero unless given
``--device cpu``.

    python examples_torch/live_coordinator_failover.py
    python examples_torch/live_coordinator_failover.py --device cpu
"""
import argparse
import os
import signal
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "src"))

import numpy as np

from repro_torch.checkpoint.manifest import RunManifest
from repro_torch.kernels.fused_sgd.ops import fused_sgd
from repro_torch.run import Run, RunConfig, start_run
from repro_torch.runtime import net
from repro_torch.runtime.devices import resolve_device
from repro_torch.runtime.live import LiveConfig
from repro_torch.runtime.protocol import ProtocolConfig
from repro_torch.runtime.workload import WorkloadSpec

NUM_BATCHES = 40
KILL_AFTER_COMMIT = 7           # SIGKILL once the manifest commits this
WAIT_S = 300.0                  # each bounded wait of the demo


def make_config(run_dir=None, transport="queue", device="cuda") -> RunConfig:
    # a wider chain + batch than the test-suite defaults: per-batch time
    # must dwarf the manifest poll interval so the SIGKILL lands
    # mid-segment, not after the run quietly finished. lr is modest: the
    # seam batches right after a resume legitimately run on the committed
    # snapshot instead of the vertically-synced stale versions an
    # uninterrupted pipeline would use, and that gap scales with lr
    return RunConfig(
        workload=WorkloadSpec(kind="mlp", seed=0, num_layers=8,
                              width=32, batch_size=64),
        live=LiveConfig(
            num_workers=3, num_batches=NUM_BATCHES, lr=0.005,
            protocol=ProtocolConfig(chain_every=8, global_every=8,
                                    repartition_first_at=10_000,
                                    detect_timeout=0.5),
            reliable_data=True, run_dir=run_dir, device=str(device)),
        transport=transport)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="torch device (cuda or cpu); without a GPU only "
                         "--device cpu runs")
    args = ap.parse_args(argv)
    try:
        device = resolve_device(args.device)
    except RuntimeError as e:
        print(f"error: {e}", file=sys.stderr)
        return 1
    return failover(device)


def failover(device) -> int:
    import multiprocessing as mp
    import tempfile

    run_dir = tempfile.mkdtemp(prefix="ftpipehd_failover_")

    # ---- uninterrupted reference (in-process queue cluster) -------------
    try:
        ref = start_run(make_config(device=device)).wait(timeout=WAIT_S)
    except TimeoutError:
        print(f"FAIL: the reference run did not finish in {WAIT_S:.0f} s")
        return 1
    print(f"reference run: {NUM_BATCHES} batches, "
          f"final loss {ref.losses[-1]:.4f}")

    # ---- phase 1: durable TCP cluster, coordinator as its own process ---
    cfg = make_config(run_dir=run_dir, transport="tcp", device=device)
    addr_of = net.cluster_addresses(cfg.live.num_workers)
    numerics = net.numerics_settings()     # every process computes alike
    ctx = mp.get_context("spawn")
    workers = [ctx.Process(target=net.worker_main,
                           args=(dev, addr_of, cfg.workload, cfg.live, 0,
                                 numerics),
                           daemon=True)
               for dev in range(1, cfg.live.num_workers)]
    coord = ctx.Process(target=net.coordinator_main,
                        args=(cfg.workload, cfg.live, addr_of,
                              cfg.to_manifest(), None, numerics),
                        daemon=True)
    net._spawn_with_pythonpath(workers + [coord])
    try:
        return _kill_and_resume(ref, run_dir, coord, workers)
    finally:
        for p in workers + [coord]:
            if p.is_alive():
                p.terminate()
                p.join(timeout=5.0)


def _kill_and_resume(ref, run_dir, coord, workers) -> int:
    # ---- phase 2: wait for a committed manifest, then SIGKILL -----------
    deadline = time.monotonic() + WAIT_S
    committed = -1
    while committed < KILL_AFTER_COMMIT:
        if time.monotonic() > deadline:
            print("FAIL: manifest never committed a mid-run batch")
            return 1
        if coord.exitcode is not None:
            print(f"FAIL: coordinator exited early ({coord.exitcode})")
            return 1
        m = RunManifest.try_load(run_dir)
        committed = m.last_committed if m is not None else -1
        time.sleep(0.002)
    os.kill(coord.pid, signal.SIGKILL)
    coord.join(timeout=10.0)
    print(f"coordinator SIGKILLed after manifest committed "
          f"batch {committed} (exit code {coord.exitcode})")

    # ---- phase 3: relaunch from the manifest, re-adopt survivors --------
    resumed = Run.resume(run_dir)
    start = resumed.config.live.start_batch
    print(f"relaunch: resuming from batch {start} "
          f"(transport={resumed.config.transport}, "
          f"device={resumed.config.live.device})")
    try:
        res = resumed.start().wait(timeout=WAIT_S)
    except TimeoutError:
        print(f"FAIL: the resumed run did not finish in {WAIT_S:.0f} s")
        return 1
    for t, e in res.events:
        print(f"  t={t:6.2f}s  {e}")

    for p in workers:
        p.join(timeout=15.0)
        if p.is_alive():
            p.terminate()
    if resumed.config.live.device.startswith("cuda"):
        print(f"  kernel launches in this process: fused_sgd "
              f"{fused_sgd.launches}")

    # ---- verification ---------------------------------------------------
    ok = True
    if coord.exitcode != -signal.SIGKILL:
        ok = False
        print(f"FAIL: coordinator did not die by SIGKILL: {coord.exitcode}")
    if any(p.exitcode != 0 for p in workers):
        ok = False
        print(f"FAIL: a surviving worker exited uncleanly: "
              f"{[p.exitcode for p in workers]}")
    readopted = [e for _, e in res.events if "re-adopted" in e]
    if not readopted:
        ok = False
        print("FAIL: survivors were never re-adopted")
    tail = [(b, l) for b, l in res.loss_log if b >= start]
    if len(tail) < NUM_BATCHES - start:
        ok = False
        print(f"FAIL: resumed run trained {len(tail)} batches, "
              f"expected {NUM_BATCHES - start}")
    div = max((abs(float(ref.losses[b]) - float(l)) for b, l in tail),
              default=float("inf"))
    print(f"resumed {len(tail)} batches from {start}; max loss divergence "
          f"vs uninterrupted reference: {div:.4f}")
    if not (div < 0.05):
        ok = False
        print("FAIL: loss diverged from the uninterrupted reference")
    print("PASS" if ok else "FAIL")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
