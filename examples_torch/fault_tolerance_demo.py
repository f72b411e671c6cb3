"""Fault-tolerance demo (paper Fig. 6), on the PyTorch port: kill worker 1
at batch 205, watch detection -> worker-list renumbering -> re-partition
-> weight redistribution -> resume, and compare the per-batch time series
against ResPipe's take-over policy.

The port of ``examples/fault_tolerance_demo.py``; it prints what that
script prints, from the port's virtual-clock simulator
(``runtime/simulator.py``). The simulator is numpy only: ``--device``
(default ``cuda``) is checked as every example of the port checks it,
and without a GPU the script exits non-zero unless given
``--device cpu``.

    python examples_torch/fault_tolerance_demo.py
    python examples_torch/fault_tolerance_demo.py --device cpu
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "src"))

import numpy as np

from repro_torch.runtime.devices import (DeviceSpec, WorkloadProfile,
                                         resolve_device, uniform_bandwidth)
from repro_torch.runtime.simulator import PipelineSimulator, SimConfig


def time_series(num_batches: int = 300, fail_at: int = 205):
    """The Fig. 6 per-batch series of both policies, worker 1 killed at
    ``fail_at``: {policy: SimResult}."""
    prof = WorkloadProfile.mobilenetv2(batch=256)
    devs = DeviceSpec.paper_trio()
    bw = uniform_bandwidth(3)
    out = {}
    for policy in ("ftpipehd", "respipe"):
        sim = PipelineSimulator(SimConfig(devs, prof, bw, policy=policy,
                                          num_batches=num_batches))
        out[policy] = sim.run(fail=(1, fail_at))
    return out


def spark(xs, lo, hi, width=72):
    chars = " .:-=+*#%@"
    idx = np.clip(((np.asarray(xs) - lo) / max(hi - lo, 1e-9) * 9), 0,
                  9).astype(int)
    step = max(1, len(xs) // width)
    return "".join(chars[i] for i in idx[::step])


def demo():
    res = time_series(num_batches=300, fail_at=205)
    ft, rp = res["ftpipehd"], res["respipe"]
    hi = float(np.percentile(np.concatenate([ft.batch_times,
                                             rp.batch_times]), 99))
    print("per-batch training time (batches 0..300; kill at 205)")
    print(f"  ftpipehd |{spark(ft.batch_times, 0, hi)}|")
    print(f"  respipe  |{spark(rp.batch_times, 0, hi)}|")
    print()
    print("ftpipehd events:")
    for t, e in ft.events:
        print(f"  t={t:9.1f}s  {e}")
    print()
    post = slice(250, 290)
    print(f"post-recovery batch time: ftpipehd "
          f"{np.median(ft.batch_times[post]):.2f}s vs respipe "
          f"{np.median(rp.batch_times[post]):.2f}s "
          f"({np.median(rp.batch_times[post])/np.median(ft.batch_times[post]):.1f}x, paper: 6.9x)")
    print(f"recovery overhead: ftpipehd {ft.recovery_overhead:.2f}s "
          f"(paper 2.24s) vs respipe {rp.recovery_overhead:.2f}s (paper 0.13s)")


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
