"""Live WAN heterogeneity demo on the PyTorch port — the paper's §IV-D
setting end to end, over EMULATED wide-area links (``runtime/netem.py``).

The port of ``examples/live_wan_heterogeneity.py``. A 3-worker
in-process cluster trains over shaped links (3ms +-1ms one-way latency,
40 MB/s token-bucket bandwidth per directed link); one device is 10x
slower (sleep-emulated), and a fast worker is killed a quarter of the
way in. The demo VERIFIES — and exits non-zero otherwise — that:

  * the kill is detected and recovered exactly once (§III-F);
  * the dynamic partitioner (§III-D) learned the 10x spread from live
    measurements and moved layers OFF the slow device, EWMA-smoothed so
    post-recovery transients don't flap the partition;
  * every message actually crossed a shaped link (netem transport stats);
  * every batch trained (no NaN losses).

The workers are threads sharing one device and its stream, so a
worker's measured time includes its neighbours' kernels; the 10x sleep
is what sets the slow device apart. It computes on ``--device`` (default
``cuda``); without a GPU it exits non-zero unless given ``--device cpu``.

    python examples_torch/live_wan_heterogeneity.py
    python examples_torch/live_wan_heterogeneity.py --device cpu
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "src"))

import numpy as np

from repro_torch.kernels.fused_sgd.ops import fused_sgd
from repro_torch.run import RunConfig, start_run
from repro_torch.runtime.devices import (DeviceSpec, resolve_device,
                                         uniform_bandwidth)
from repro_torch.runtime.live import LiveConfig
from repro_torch.runtime.netem import NetemSpec
from repro_torch.runtime.protocol import ProtocolConfig
from repro_torch.runtime.workload import WorkloadSpec

NL, NUM_BATCHES = 12, 16
KILL_DEV, KILL_BATCH = 1, 4
WAIT_S = 600.0                  # the run must finish within this


def config(device="cuda") -> RunConfig:
    return RunConfig(
        workload=WorkloadSpec(kind="mlp", seed=0, num_layers=NL,
                              width=256, batch_size=64),
        live=LiveConfig(
            num_workers=3, num_batches=NUM_BATCHES,
            protocol=ProtocolConfig(chain_every=8, global_every=10_000,
                                    repartition_first_at=4,
                                    repartition_every=6,
                                    detect_timeout=0.5,
                                    refit_hysteresis=0.25),
            lr=0.05,
            device_specs=[DeviceSpec("fast-0", 1.0),
                          DeviceSpec("fast-1", 1.0),
                          DeviceSpec("slow", 10.0)],
            bandwidth=uniform_bandwidth(3, 40e6),
            emulate_capacity=True, capacity_source="measured",
            capacity_ema=0.7,
            netem=NetemSpec.wan(latency=0.003, jitter=0.001, rate=40e6,
                                seed=7),
            kill=(KILL_DEV, KILL_BATCH), device=str(device)))


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

    print(f"WAN run: 3 workers (capacities 1/1/10x-slow), shaped links, "
          f"kill worker {KILL_DEV} @batch {KILL_BATCH}")
    for t, e in res.events:
        print(f"  t={t:6.2f}s  {e}")
    stats = res.transport_stats
    print(f"  netem: shaped={stats.get('shaped', 0)} "
          f"dropped={stats.get('netem_dropped', 0)} "
          f"blocked={stats.get('netem_blocked', 0)}")
    if device.type == "cuda":
        print(f"  kernel launches in this process: fused_sgd "
              f"{fused_sgd.launches}")

    ok = True
    if np.isnan(res.losses).any():
        ok = False
        print("FAIL: some batches never completed:",
              np.flatnonzero(np.isnan(res.losses)))
    if len(res.recoveries) != 1:
        ok = False
        print(f"FAIL: expected exactly 1 recovery, got "
              f"{len(res.recoveries)}")
    if stats.get("shaped", 0) == 0:
        ok = False
        print("FAIL: no message ever crossed a shaped link — netem spec "
              "was not applied")
    # dynamic partition: the surviving pair is (fast, 10x slow); the last
    # stage IS the slow device after renumbering, and the learned cut must
    # starve it well below the equal split
    points = res.final_partition
    slow_layers = (NL - 1) - points[-2] if len(points) >= 2 else NL
    print(f"  final partition points {tuple(points)} -> slow device runs "
          f"{slow_layers}/{NL} layers (equal split would be {NL // 2})")
    if not (len(points) == 2 and slow_layers < NL // 2):
        ok = False
        print("FAIL: partitioner did not move layers off the slow device")
    print("PASS" if ok else "FAIL")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
