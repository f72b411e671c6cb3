"""LIVE fault-tolerance demo on the PyTorch port — the executable
counterpart of ``fault_tolerance_demo.py`` (which plots the SIMULATOR's
virtual-clock prediction of the same protocol).

The port of ``examples/live_fault_tolerance.py``. Real FTPipeHD training
on a 3-worker in-process cluster: worker 1 is killed mid-run; the
coordinator's heartbeat timer detects it (§III-F), probes, renumbers the
worker list, re-partitions over the survivors, and redistributes weights
from live slices + chain/global replicas — then training resumes from
the last committed batch. Every stage's backward applies its update
through the fused-SGD kernel. The demo VERIFIES loss continuity across
the failure (post-recovery loss keeps improving instead of resetting to
the untrained level) and exits non-zero otherwise. It computes on
``--device`` (default ``cuda``); without a GPU it exits non-zero unless
given ``--device cpu``.

    python examples_torch/live_fault_tolerance.py
    python examples_torch/live_fault_tolerance.py --device cpu
"""
import argparse
import os
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

KILL_DEV, KILL_BATCH, NUM_BATCHES = 1, 18, 40
WAIT_S = 600.0                  # the run must finish within this


def spark(xs, lo, hi, width=60):
    chars = " .:-=+*#%@"
    idx = np.clip(((np.asarray(xs) - lo) / max(hi - lo, 1e-9) * 9), 0,
                  9).astype(int)
    step = max(1, len(xs) // width)
    return "".join(chars[i] for i in idx[::step])


def config(device="cuda") -> RunConfig:
    return RunConfig(
        workload=WorkloadSpec(kind="mlp", seed=0, num_layers=8),
        live=LiveConfig(
            num_workers=3, num_batches=NUM_BATCHES,
            protocol=ProtocolConfig(chain_every=10, global_every=20,
                                    repartition_first_at=5,
                                    repartition_every=15,
                                    detect_timeout=0.4),
            lr=0.1, kill=(KILL_DEV, KILL_BATCH), device=str(device)))


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

    print(f"live run: kill worker {KILL_DEV} @batch {KILL_BATCH} "
          f"({NUM_BATCHES} batches total)")
    print(f"  loss |{spark(res.losses, 0, float(np.nanmax(res.losses)))}|")
    for t, e in res.events:
        print(f"  t={t:6.2f}s  {e}")
    if device.type == "cuda":
        print(f"  kernel launches in this process: fused_sgd "
              f"{fused_sgd.launches}")

    # ---- verification: every batch trained, loss continuous ------------
    ok = True
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
        # continuity: recovery resumed from trained weights, i.e. the
        # post-recovery loss is far below the untrained level and did not
        # regress much past the pre-failure level
        if not (post < 0.7 * first and post < 2.0 * pre):
            ok = False
            print("FAIL: loss discontinuity across recovery")
    final_stages = len(res.final_partition)
    if final_stages != 2:
        ok = False
        print(f"FAIL: expected 2 surviving stages, got {final_stages}")
    print("PASS" if ok else "FAIL")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
