"""Fleet-level fault tolerance demo on the PyTorch port — kill a WHOLE
CHAIN, not a worker.

The port of ``examples/live_fleet_chain_failure.py``. Two data-parallel
pipeline chains (``runtime/fleet.py``) train the same model over TCP:
each chain is a full coordinator + 2 worker PROCESSES on a disjoint shard
of the batch stream, and the chains meet every 6 committed batches at
the weight-aggregation barrier. Mid-run, EVERY worker process of chain 1
SIGKILLs itself at once — the chain drops below ``min_chain_workers``
and collapses as a unit, which is a fault class §III-F cannot absorb
(there is nobody left inside the chain to redistribute to). The fleet
layer handles it instead:

  1. the collapsing chain reports itself dead; the barrier stops
     waiting for it and the fleet DEGRADES to the surviving chain,
     which keeps training (and publishing solo rounds);
  2. after the next published round, a fresh incarnation of chain 1 is
     RE-ADMITTED — relaunched from that round's fleet-mean weights and
     batch offset, rejoining the trajectory instead of restarting.

The demo verifies the mechanics (real SIGKILLs, a degraded round, a
second incarnation that finishes cleanly) AND the training outcome: the
final fleet loss must sit within 0.05 of an unkilled reference fleet
run. Exits non-zero otherwise. Every process computes on ``--device``
(default ``cuda``; on one GPU the chains' processes share it); without a
GPU the demo exits non-zero unless given ``--device cpu``.

    python examples_torch/live_fleet_chain_failure.py
    python examples_torch/live_fleet_chain_failure.py --device cpu
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
from repro_torch.runtime.fleet import FleetConfig
from repro_torch.runtime.live import LiveConfig
from repro_torch.runtime.protocol import ProtocolConfig
from repro_torch.runtime.workload import WorkloadSpec

KILL_CHAIN, KILL_BATCH, NUM_BATCHES, FLEET_EVERY = 1, 9, 24, 6
WAIT_S = 600.0                  # each fleet run must finish within this


def fleet_config(kill: bool, device="cuda") -> RunConfig:
    return RunConfig(
        workload=WorkloadSpec(kind="mlp", seed=0, num_layers=8,
                              num_data_batches=8),
        live=LiveConfig(
            num_workers=3, num_batches=NUM_BATCHES, lr=0.1,
            protocol=ProtocolConfig(chain_every=6, global_every=12,
                                    detect_timeout=0.75),
            device=str(device)),
        fleet=FleetConfig(
            chains=2, aggregate_every=FLEET_EVERY, barrier_timeout=60.0,
            min_chain_workers=2,
            kill_chain=(KILL_CHAIN, KILL_BATCH) if kill else None),
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
    print(f"fleet run: 2 chains x 3 workers over TCP, aggregate every "
          f"{FLEET_EVERY} batches; SIGKILL ALL of chain {KILL_CHAIN}'s "
          f"worker processes @batch {KILL_BATCH} "
          f"({NUM_BATCHES} batches/chain)")
    try:
        res = start_run(fleet_config(True, device)).wait(timeout=WAIT_S)
    except TimeoutError:
        print(f"FAIL: the fleet run did not finish in {WAIT_S:.0f} s")
        return 1
    for t, e in sorted(res.events):
        print(f"  t={t:6.2f}s  {e}")
    print(f"  rounds: {res.rounds}")
    print(f"  incarnations: {res.incarnations}")
    print(f"  worker exit codes: {res.exitcodes}")

    print("reference fleet run (no kill) ...")
    try:
        ref = start_run(fleet_config(False, device)).wait(timeout=WAIT_S)
    except TimeoutError:
        print(f"FAIL: the reference fleet run did not finish in "
              f"{WAIT_S:.0f} s")
        return 1
    if device.type == "cuda":
        print(f"  kernel launches in this process: fused_sgd "
              f"{fused_sgd.launches}")

    # ---- verification --------------------------------------------------
    ok = True
    killed = res.exitcodes.get(KILL_CHAIN, {}).get(1, {})  # incarnation 1
    if not killed or any(code != -signal.SIGKILL for code in killed.values()):
        ok = False
        print(f"FAIL: chain {KILL_CHAIN}'s workers did not die by SIGKILL: "
              f"{killed}")
    if res.chain_errors:
        ok = False
        print(f"FAIL: a chain's FINAL incarnation failed: "
              f"{res.chain_errors}")
    if res.incarnations.get(KILL_CHAIN, 0) < 2:
        ok = False
        print(f"FAIL: chain {KILL_CHAIN} was never re-admitted: "
              f"incarnations={res.incarnations}")
    degraded = [r for r in res.rounds if KILL_CHAIN in r["degraded"]
                or r["contributors"] == [0]]
    if not degraded:
        ok = False
        print(f"FAIL: no round ran degraded without chain {KILL_CHAIN}: "
              f"{res.rounds}")
    rejoined = [r for r in res.rounds
                if r["batch"] > KILL_BATCH and KILL_CHAIN
                in r["contributors"] and len(r["contributors"]) > 1]
    if not rejoined:
        # the re-admitted incarnation may legitimately finish solo (the
        # survivor already done) — it must at least have produced a result
        if res.chains.get(KILL_CHAIN) is None:
            ok = False
            print(f"FAIL: re-admitted chain {KILL_CHAIN} produced no "
                  f"result")
    loss_kill, loss_ref = res.final_loss, ref.final_loss
    print(f"  final fleet loss: killed-chain run {loss_kill:.4f} vs "
          f"unkilled reference {loss_ref:.4f} "
          f"(|diff| = {abs(loss_kill - loss_ref):.4f})")
    if not (abs(loss_kill - loss_ref) < 0.05):
        ok = False
        print("FAIL: loss diverged past 0.05 after chain loss + "
              "re-admission")
    print("PASS" if ok else "FAIL")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
