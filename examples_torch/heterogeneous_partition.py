"""Dynamic model partition demo (paper Fig. 5 setting), on the PyTorch
port: watch the partition points move as the central node learns each
device's real capacity, and the per-batch time drop.

The port of ``examples/heterogeneous_partition.py``; it prints what that
script prints. The simulator is numpy only: ``--device`` (default
``cuda``) is checked as every example of the port checks it, and without
a GPU the script exits non-zero unless given ``--device cpu``.

    python examples_torch/heterogeneous_partition.py
    python examples_torch/heterogeneous_partition.py --device cpu
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "src"))

import numpy as np

from repro_torch.core.partition import solve_partition, uniform_partition
from repro_torch.runtime.devices import (DeviceSpec, WorkloadProfile,
                                         resolve_device, uniform_bandwidth)
from repro_torch.runtime.simulator import (PipelineSimulator, SimConfig,
                                           single_device_time)


def demo():
    prof = WorkloadProfile.mobilenetv2(batch=256)
    devs = DeviceSpec.paper_trio()          # capacities 1.0, 1.0, 10.0
    print("devices:", [(d.name, d.capacity) for d in devs])

    u = uniform_partition(prof.num_layers, 3)
    print(f"\ninitial (homogeneous assumption): counts={u.counts}")
    opt = solve_partition(prof.exec_times, prof.out_bytes,
                          np.array([1.0, 1.0, 10.0]),
                          np.array([10e6 / 8] * 2))
    print(f"capacity-aware DP:                 counts={opt.counts} "
          f"(slow device starved, bottleneck {opt.bottleneck:.2f}s)")

    for policy in ("ftpipehd", "pipedream"):
        sim = PipelineSimulator(SimConfig(devs, prof, uniform_bandwidth(3),
                                          policy=policy, num_batches=300))
        r = sim.run()
        print(f"\n{policy}:")
        for b, pts in r.partitions:
            counts = np.diff(np.concatenate([[-1], pts])).tolist()
            print(f"  from batch {b:4d}: layers/stage = {counts}")
        print(f"  steady per-batch {r.steady_batch_time():.2f}s; "
              f"epoch total {r.total_time:.0f}s")
    single = single_device_time(prof, 1.0, 300)
    print(f"\nsingle fastest device epoch: {single:.0f}s")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="torch device (cuda or cpu); without a GPU only "
                         "--device cpu runs")
    args = ap.parse_args(argv)
    try:
        resolve_device(args.device)
    except RuntimeError as e:
        print(f"error: {e}", file=sys.stderr)
        return 1
    demo()
    return 0


if __name__ == "__main__":
    sys.exit(main())
