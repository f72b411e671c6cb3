"""Readings that the limits of ``cells/<cell>.json`` are set from.

    python portbench/calibrate.py --workload <cell> --seeds 1 2 3 ... \
        [--control 3] [--faults half_batch] [--seconds 3] [--detail]

For each seed, one JSON line of the check's numbers (``Driver.readings``,
no limit applied) for:
- ``program``: the program's timed path (set-up's first steps; for a
  prefill cell also a short window of calls) against the reference;
- ``control`` (the first ``--control`` seeds): the reference in lower
  precision (``Reference(precision="control")``) in the program's place
  (the kind's ``control_readings``);
- each fault of ``--faults`` (on the first three seeds), planted under
  the program's timed path as the harness's tests plant it.
``--detail`` adds, for train cells, the five leaves whose first gradient
reads worst. The benchmark's own runs never run this; it needs the card
(the tests call its functions on the CPU with small cells).
"""
from __future__ import annotations

import argparse
import gc
import json
import pathlib
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def program_readings(cell, seed, device, seconds, fault=None, detail=False):
    import torch
    from portbench import harness
    state = harness.RunState(cell, harness.port_config(cell.config), seed,
                             torch.device(device), fault)
    driver = cell.kind.Driver(state)
    driver.setup()
    i, t0 = driver.first_unit, time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        driver.call(i)
        i += 1
    driver.free()
    _free(device)
    out = driver.readings(detail=True) if detail else driver.readings()
    del driver
    _free(device)
    return out


def _free(device):
    gc.collect()
    if device == "cuda":
        import torch
        torch.cuda.empty_cache()


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control", type=int, default=0)
    ap.add_argument("--faults", nargs="*", default=[])
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--detail", action="store_true",
                    help="train cells: the five leaves whose first gradient "
                         "reads worst")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT / "src"))
    from portbench import harness
    bench = harness.load_json(ROOT / "BENCHMARK.json")
    cell = harness.resolve(bench, args.workload)
    jobs = [("program", s) for s in args.seeds]
    jobs += [("control", s) for s in args.seeds[:args.control]]
    jobs += [(f, s) for f in args.faults for s in args.seeds[:3]]
    for mode, seed in jobs:
        t0 = time.perf_counter()
        detail = args.detail and cell.mix["kind"] == "train"
        if mode == "control":
            out = cell.kind.control_readings(cell, seed, "cuda", detail)
        else:
            out = program_readings(cell, seed, "cuda", args.seconds,
                                   None if mode == "program" else mode,
                                   detail)
        print(json.dumps({"cell": cell.name, "mode": mode, "seed": seed,
                          "seconds": time.perf_counter() - t0, **out}),
              flush=True)


if __name__ == "__main__":
    main()
