"""COMPRESSED-WIRE acceptance demo on the PyTorch port: quantized
data-plane traffic must not change what the model learns.

The port of ``examples/live_compressed_wire.py``. Runs the same
multi-process TCP training twice — coordinator + 2 worker processes over
``runtime/net.py``, identical seed and protocol schedule — first with
the exact f32 wire, then with the int8 tier (``--wire-compress int8``:
per-tensor affine quantization of activations, gradient cotangents, and
§III-E replica snapshots on the host, ``runtime/codec.py``). It then
VERIFIES, exiting non-zero on any regression:

  * loss parity — the compressed run's per-batch losses track the exact
    run within quantization noise (a compressor that changes convergence
    is a bug, not a feature);
  * the compression actually happened — the coordinator endpoint's
    data-plane wire bytes (``stats["data_bytes"]``) shrink >= 2.5x.

Then it repeats the experiment on the FUSED on-device tier
(``--wire-compress int8-fused``: per-channel quantization with
error-feedback residuals inside the stage step, the quantize and
dequantize kernels of ``kernels/quant``, shipped as codec tag 13) — this
time with a worker KILLED mid-run on both sides, so the §III-F detect ->
recover -> resume path is exercised over quantized frames. The kill pair
runs on the in-process queue transport (codec on, same byte-level wire
format): a real SIGKILL's detection point is wall-clock
nondeterministic, so over TCP the two runs can restart from different
batches and the loss comparison would measure recovery TIMING, not
quantization — the queue transport injects the kill at a deterministic
batch, isolating the tier's effect. Replica snapshots stay exact for
this pair so the divergence is attributable to the data plane alone.
Acceptance: both runs recover exactly once, fused losses track the exact
kill run within the same tolerance, and the fused data plane still
shrinks. On a GPU the injected kill's batch is deterministic but the
batch the run resumes at is not: a batch already past the killed worker
may still commit before the failure is detected (the exact run resumed
at 10 or 9, the fused one at 9), and two runs that resume at different
batches differ at the seam by far more than quantization. So the pair
runs again, up to ``KILL_ATTEMPTS`` times, until both resume at the same
batch, and fails if they never do. It computes on ``--device`` (default ``cuda``); without a GPU
it exits non-zero unless given ``--device cpu``.

    python examples_torch/live_compressed_wire.py
    python examples_torch/live_compressed_wire.py --device cpu
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "src"))

import numpy as np

from repro_torch.kernels.fused_sgd.ops import fused_sgd
from repro_torch.kernels.quant.ops import dequantize, quantize_ef
from repro_torch.run import RunConfig, start_run
from repro_torch.runtime.devices import resolve_device
from repro_torch.runtime.live import LiveConfig
from repro_torch.runtime.protocol import ProtocolConfig
from repro_torch.runtime.workload import WorkloadSpec

NUM_BATCHES = 20
LOSS_ATOL = 0.05          # quantization noise, not divergence
MIN_RATIO = 2.5           # data-plane bytes, f32 / int8
MIN_RATIO_FUSED = 2.0     # per-channel params cost more than per-tensor
KILL = (1, 8)             # kill worker 1 at batch 8 (fused pair only)
KILL_ATTEMPTS = 8         # fused pairs run until both resume at one batch
WAIT_S = 600.0            # each run must finish within this


def config(tier: str, kill=None, replica=None, transport="tcp",
           device="cuda") -> RunConfig:
    return RunConfig(
        workload=WorkloadSpec(kind="mlp", seed=0, num_layers=8),
        live=LiveConfig(
            num_workers=3, num_batches=NUM_BATCHES,
            # re-partition off: the two runs must make identical protocol
            # decisions so the ONLY difference on the wire is the tier
            protocol=ProtocolConfig(chain_every=8, global_every=16,
                                    repartition_first_at=10_000,
                                    repartition_every=10_000,
                                    detect_timeout=0.5),
            lr=0.1, wire_compress=tier, wire_compress_replica=replica,
            wire_codec=True, kill=kill, device=str(device)),
        transport=transport)


def run(tier: str, kill=None, replica=None, transport="tcp",
        device="cuda"):
    return start_run(config(tier, kill, replica, transport,
                            device)).wait(timeout=WAIT_S)


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
        return compare(device)
    except TimeoutError:
        print(f"FAIL: a run did not finish in {WAIT_S:.0f} s")
        return 1


def compare(device) -> int:
    plain = run("off", device=device)
    q8 = run("int8", device=device)

    s0, s1 = plain.transport_stats, q8.transport_stats
    data_ratio = s0["data_bytes"] / max(s1["data_bytes"], 1)
    replica_ratio = s0["replica_bytes"] / max(s1["replica_bytes"], 1)
    diff = float(np.nanmax(np.abs(q8.losses - plain.losses)))
    print(f"compressed-wire TCP parity: {NUM_BATCHES} batches, "
          f"3 workers (2 worker processes), int8 vs exact f32")
    print(f"  losses  f32 : {np.round(plain.losses[-5:], 4)} (last 5)")
    print(f"  losses int8 : {np.round(q8.losses[-5:], 4)} (last 5)")
    print(f"  max |loss diff| = {diff:.5f} (tolerance {LOSS_ATOL})")
    print(f"  coordinator data-plane bytes: {s0['data_bytes']} -> "
          f"{s1['data_bytes']} ({data_ratio:.2f}x smaller)")
    print(f"  coordinator replica bytes:    {s0['replica_bytes']} -> "
          f"{s1['replica_bytes']} ({replica_ratio:.2f}x smaller)")

    # ---- verification --------------------------------------------------
    ok = True
    for name, res in (("f32", plain), ("int8", q8)):
        if np.isnan(res.losses).any():
            ok = False
            print(f"FAIL: {name} run left batches unfinished:",
                  np.flatnonzero(np.isnan(res.losses)))
        if res.recoveries:
            ok = False
            print(f"FAIL: {name} run hit unexpected recoveries:",
                  res.recoveries)
        if any(c != 0 for c in res.worker_exitcodes.values()):
            ok = False
            print(f"FAIL: {name} run had unclean worker exits:",
                  res.worker_exitcodes)
    if not (diff <= LOSS_ATOL):
        ok = False
        print(f"FAIL: compressed losses diverged from exact f32 "
              f"({diff:.5f} > {LOSS_ATOL})")
    first = float(np.median(plain.losses[:3]))
    last = float(np.median(q8.losses[-5:]))
    if not (last < 0.8 * first):
        ok = False
        print(f"FAIL: compressed run did not train ({first:.3f} -> "
              f"{last:.3f})")
    if data_ratio < MIN_RATIO:
        ok = False
        print(f"FAIL: int8 only cut data-plane bytes {data_ratio:.2f}x "
              f"(acceptance floor {MIN_RATIO}x)")

    # ---- fused on-device tier, under a mid-run worker kill -------------
    # replica snapshots exact on BOTH sides: recovery restores identical
    # state, so any loss divergence is the fused data plane's doing
    for attempt in range(1, KILL_ATTEMPTS + 1):
        exact_kill = run("off", kill=KILL, replica="off", transport="queue",
                         device=device)
        fused_kill = run("int8-fused", kill=KILL, replica="off",
                         transport="queue", device=device)
        resumed = [[r["restart"] for r in res.recoveries]
                   for res in (exact_kill, fused_kill)]
        if resumed[0] == resumed[1]:
            break
        print(f"  kill pair {attempt}: the runs resumed at batches "
              f"{resumed[0]} / {resumed[1]}; running the pair again")
    else:
        ok = False
        print(f"FAIL: in {KILL_ATTEMPTS} kill pairs the two runs never "
              f"resumed at the same batch")
    sk0, sk1 = exact_kill.transport_stats, fused_kill.transport_stats
    fused_ratio = sk0["data_bytes"] / max(sk1["data_bytes"], 1)
    kdiff = float(np.nanmax(np.abs(fused_kill.losses - exact_kill.losses)))
    print(f"fused-wire kill/recovery parity: worker {KILL[0]} killed at "
          f"batch {KILL[1]}, int8-fused vs exact f32")
    print(f"  losses  f32 : {np.round(exact_kill.losses[-5:], 4)} (last 5)")
    print(f"  losses fused: {np.round(fused_kill.losses[-5:], 4)} (last 5)")
    print(f"  max |loss diff| = {kdiff:.5f} (tolerance {LOSS_ATOL})")
    print(f"  coordinator data-plane bytes: {sk0['data_bytes']} -> "
          f"{sk1['data_bytes']} ({fused_ratio:.2f}x smaller)")
    if device.type == "cuda":
        print(f"  kernel launches in this process: fused_sgd "
              f"{fused_sgd.launches}, quantize_ef {quantize_ef.launches}, "
              f"dequantize {dequantize.launches}")
    for name, res in (("exact-kill", exact_kill),
                      ("fused-kill", fused_kill)):
        if np.isnan(res.losses).any():
            ok = False
            print(f"FAIL: {name} run left batches unfinished:",
                  np.flatnonzero(np.isnan(res.losses)))
        if len(res.recoveries) != 1:
            ok = False
            print(f"FAIL: {name} run expected exactly 1 recovery, got:",
                  res.recoveries)
    if not (kdiff <= LOSS_ATOL):
        ok = False
        print(f"FAIL: fused losses diverged from exact f32 under kill "
              f"({kdiff:.5f} > {LOSS_ATOL})")
    first = float(np.median(exact_kill.losses[:3]))
    last = float(np.median(fused_kill.losses[-5:]))
    if not (last < 0.8 * first):
        ok = False
        print(f"FAIL: fused kill run did not train ({first:.3f} -> "
              f"{last:.3f})")
    if fused_ratio < MIN_RATIO_FUSED:
        ok = False
        print(f"FAIL: fused tier only cut data-plane bytes "
              f"{fused_ratio:.2f}x (acceptance floor {MIN_RATIO_FUSED}x)")
    print("PASS" if ok else "FAIL")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
