"""ELASTIC-MEMBERSHIP demo on the PyTorch port — SIGKILL, relaunch,
rejoin, and a pipeline that grows back to full width.

The port of ``examples/live_elastic_rejoin.py``. Real FTPipeHD training
on a coordinator + 2 worker PROCESSES over localhost TCP
(``runtime/net.py``). Mid-run, worker 1 is SIGKILLed (the process dies
with sockets mid-stream; §III-F recovery shrinks the pipeline to 2
devices) — and then RELAUNCHED: a fresh process with a bumped
incarnation re-handshakes over the wire (``hello``), is admitted at the
next control point, the §III-D partition expands back to 3 devices, and
the joiner's slice is rebuilt from live peers with the chain/global
replica fallbacks (§III-E/F).

The demo VERIFIES — and exits non-zero otherwise — that:

  * the first incarnation really died by SIGKILL (exit code -9) and the
    relaunched one exited cleanly (exit-code history ``[-9, 0]``),
  * exactly one §III-F recovery and one admission happened,
  * the final partition spans all 3 devices again,
  * every batch completed and the loss stayed continuous across BOTH the
    kill and the rejoin window.

It computes on ``--device`` (default ``cuda``); without a GPU it exits
non-zero unless given ``--device cpu``.

    python examples_torch/live_elastic_rejoin.py
    python examples_torch/live_elastic_rejoin.py --device cpu
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

KILL_DEV, KILL_BATCH, REJOIN_BATCH, NUM_BATCHES = 1, 10, 14, 40
WAIT_S = 600.0                  # the run must finish within this


def config(device="cuda") -> RunConfig:
    return RunConfig(
        workload=WorkloadSpec(kind="mlp", seed=0, num_layers=8),
        live=LiveConfig(
            num_workers=3, num_batches=NUM_BATCHES,
            protocol=ProtocolConfig(chain_every=8, global_every=16,
                                    repartition_first_at=10_000,
                                    repartition_every=10_000,
                                    detect_timeout=0.5),
            lr=0.1, kill=(KILL_DEV, KILL_BATCH),
            rejoin=(KILL_DEV, REJOIN_BATCH), join_wait=90,
            device=str(device)),
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

    print(f"elastic TCP cluster run: SIGKILL worker {KILL_DEV} "
          f"@batch {KILL_BATCH}, relaunch @batch {REJOIN_BATCH} "
          f"({NUM_BATCHES} batches total)")
    for t, e in res.events:
        print(f"  t={t:6.2f}s  {e}")
    print(f"  exit-code history: {res.exitcode_history}")
    parts = [(b, tuple(int(p) for p in pts)) for b, pts in res.partitions]
    print(f"  partitions: {parts}")
    if device.type == "cuda":
        print(f"  kernel launches in this process: fused_sgd "
              f"{fused_sgd.launches}")

    # ---- verification --------------------------------------------------
    ok = True
    hist = res.exitcode_history.get(KILL_DEV, [])
    if len(hist) != 2 or hist[0] != -signal.SIGKILL:
        ok = False
        print(f"FAIL: expected incarnation history [-9, 0] for worker "
              f"{KILL_DEV}, got {hist}")
    elif hist[1] != 0:
        ok = False
        print(f"FAIL: the relaunched worker exited uncleanly: {hist}")
    if len(res.recoveries) != 1:
        ok = False
        print(f"FAIL: expected exactly one recovery, "
              f"got {res.recoveries}")
    if len(res.admissions) != 1 \
            or res.admissions[0]["devs"] != [KILL_DEV]:
        ok = False
        print(f"FAIL: expected one admission of dev {KILL_DEV}, "
              f"got {res.admissions}")
    if len(res.final_partition) != 3:
        ok = False
        print(f"FAIL: final partition does not span 3 devices: "
              f"{res.final_partition}")
    if np.isnan(res.losses).any():
        ok = False
        print("FAIL: some batches never completed:",
              np.flatnonzero(np.isnan(res.losses)))
    elif res.admissions and res.recoveries:
        # loss continuity across the whole kill -> rejoin window
        adm_b = res.admissions[0]["batch"]
        pre = float(np.median(res.losses[max(0, KILL_BATCH - 5):KILL_BATCH]))
        post = float(np.median(res.losses[adm_b:adm_b + 5]))
        first = float(np.median(res.losses[:3]))
        print(f"  pre-kill loss {pre:.3f} -> post-rejoin {post:.3f} "
              f"(untrained: {first:.3f})")
        if not (post < 0.7 * first and post < 2.0 * pre):
            ok = False
            print("FAIL: loss discontinuity across the kill/rejoin window")
    print("PASS" if ok else "FAIL")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
