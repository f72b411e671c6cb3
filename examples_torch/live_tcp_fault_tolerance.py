"""MULTI-PROCESS fault-tolerance demo on the PyTorch port — the TCP
counterpart of ``live_fault_tolerance.py`` (which runs the same protocol
over worker THREADS and an in-memory queue).

The port of ``examples/live_tcp_fault_tolerance.py``. Real FTPipeHD
training on a coordinator + 2 worker PROCESSES talking length-prefixed
TCP on localhost (``runtime/net.py``), each process with its own device
context. Worker 1 is killed mid-run — and "killed" here means the
process SIGKILLs itself: sockets break mid-stream, heartbeats stop, and
the coordinator's §III-F path (timeout -> probe -> classify -> renumber
-> re-partition -> weight redistribution) recovers from observed
silence, exactly as with a crashed edge device. The demo VERIFIES that
the worker really died by SIGKILL (exit code -9), that training
completed every batch on the survivors, and that the loss stayed
continuous across the failure — and exits non-zero otherwise. It
computes on ``--device`` (default ``cuda``); without a GPU it exits
non-zero unless given ``--device cpu``.

    python examples_torch/live_tcp_fault_tolerance.py
    python examples_torch/live_tcp_fault_tolerance.py --device cpu
"""
import argparse
import os
import signal
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "src"))

import numpy as np

from repro_torch.kernels.fused_sgd.ops import fused_sgd
from repro_torch.run import RunConfig, start_run
from repro_torch.runtime.devices import resolve_device
from repro_torch.runtime.live import LiveConfig
from repro_torch.runtime.protocol import ProtocolConfig
from repro_torch.runtime.workload import WorkloadSpec

KILL_DEV, KILL_BATCH, NUM_BATCHES = 1, 14, 32
WAIT_S = 600.0                  # the run must finish within this


def config(device="cuda") -> RunConfig:
    return RunConfig(
        workload=WorkloadSpec(kind="mlp", seed=0, num_layers=8),
        live=LiveConfig(
            num_workers=3, num_batches=NUM_BATCHES,
            protocol=ProtocolConfig(chain_every=10, global_every=20,
                                    repartition_first_at=5,
                                    repartition_every=15,
                                    detect_timeout=0.5),
            lr=0.1, kill=(KILL_DEV, KILL_BATCH), device=str(device)),
        transport="tcp")


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
    try:
        res = start_run(config(device)).wait(timeout=WAIT_S)
    except TimeoutError:
        print(f"FAIL: the run did not finish in {WAIT_S:.0f} s")
        return 1

    print(f"TCP cluster run: coordinator + 2 worker processes, SIGKILL "
          f"worker {KILL_DEV} @batch {KILL_BATCH} "
          f"({NUM_BATCHES} batches total)")
    for t, e in res.events:
        print(f"  t={t:6.2f}s  {e}")
    print(f"  worker exit codes: {res.worker_exitcodes}")
    s = res.transport_stats
    print(f"  coordinator transport: {s['delivered']} delivered, "
          f"{s['bytes'] / 1e6:.2f} MB in, {s['tx_bytes'] / 1e6:.2f} MB out")
    if device.type == "cuda":
        print(f"  kernel launches in this process: fused_sgd "
              f"{fused_sgd.launches}")

    # ---- verification --------------------------------------------------
    ok = True
    if res.worker_exitcodes.get(KILL_DEV) != -signal.SIGKILL:
        ok = False
        print(f"FAIL: worker {KILL_DEV} did not die by SIGKILL: "
              f"{res.worker_exitcodes}")
    if any(code not in (0,) for dev, code in res.worker_exitcodes.items()
           if dev != KILL_DEV):
        ok = False
        print(f"FAIL: a surviving worker exited uncleanly: "
              f"{res.worker_exitcodes}")
    if np.isnan(res.losses).any():
        ok = False
        print("FAIL: some batches never completed:",
              np.flatnonzero(np.isnan(res.losses)))
    if not res.recoveries:
        ok = False
        print("FAIL: the kill was never detected/recovered")
    else:
        r = res.recoveries[0]
        pre = float(np.median(res.losses[r["restart"] - 6:r["restart"] - 1]))
        post = float(np.median(res.losses[r["restart"]:r["restart"] + 5]))
        first = float(np.median(res.losses[:3]))
        print(f"  pre-failure loss {pre:.3f} -> post-recovery {post:.3f} "
              f"(untrained: {first:.3f})")
        if not (post < 0.7 * first and post < 2.0 * pre):
            ok = False
            print("FAIL: loss discontinuity across recovery")
    if len(res.final_partition) != 2:
        ok = False
        print(f"FAIL: expected 2 surviving stages, "
              f"got {len(res.final_partition)}")
    print("PASS" if ok else "FAIL")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
