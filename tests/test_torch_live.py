"""The port's live runtime (``repro_torch.runtime.live``) against the JAX
reference on identical weights: the mlp chain, the queue transport, 3
workers with spec capacities (1, 1, 4), worker 1 killed at batch 12 — the
settings of ``tests/test_live_runtime.py::
test_post_recovery_partition_matches_simulator_prediction``.

What must match, and how closely:
  * every partition the run solved (initial, §III-D re-partition, §III-F
    recovery): identical points. Both runs get the same profile, so the
    same protocol code must take the same decisions;
  * the recovery record: the same failed worker and the same partition;
  * per-batch losses before the recovery's restart batch: rtol 1e-4, atol
    1e-5 — up to there the async 1F1B schedule is deterministic (vertical
    sync fixes each batch's weight version), and the two packages differ
    only by f32 rounding;
  * losses from the restart on: both finite, and each run's last five
    below its first five. After the kill the survivors may already have
    applied updates of batches that were never committed, and how many
    depends on thread timing, so the two runs legitimately part ways.
"""
import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from repro.runtime import live as ref_live  # noqa: E402
from repro.runtime import workload as ref_wl  # noqa: E402
from repro.runtime.devices import DeviceSpec as RefDeviceSpec  # noqa: E402
from repro.runtime.devices import uniform_bandwidth as ref_bw  # noqa: E402
from repro.runtime.protocol import ProtocolConfig as RefProtocol  # noqa: E402
from repro_torch.runtime import live  # noqa: E402
from repro_torch.runtime import workload as wl  # noqa: E402
from repro_torch.runtime.devices import (DeviceSpec, WorkloadProfile,  # noqa: E402
                                         uniform_bandwidth)
from repro_torch.runtime.protocol import ProtocolConfig  # noqa: E402

B = 30
PROTO = dict(chain_every=10, global_every=20, repartition_first_at=5,
             repartition_every=15, detect_timeout=1.0)
CAPS = [("central", 1.0), ("peer", 1.0), ("slow", 4.0)]


def _points(parts):
    return [tuple(int(p) for p in pts) for _, pts in parts]


@pytest.fixture(scope="module")
def runs():
    ref_chain = ref_wl.mlp_chain(jax.random.PRNGKey(0), num_layers=8)
    ref_data = ref_wl.classification_batches("mlp", 8, batch=16, seed=0)
    prof = ref_chain.measure_profile(ref_data[0], repeats=2)
    ref = ref_live.run_live_training(ref_chain, ref_data, ref_live.LiveConfig(
        num_workers=3, num_batches=B, protocol=RefProtocol(**PROTO), lr=0.1,
        device_specs=[RefDeviceSpec(n, c) for n, c in CAPS],
        bandwidth=ref_bw(3, 1e9), profile=prof, capacity_source="spec",
        kill=(1, 12)))

    chain = wl.mlp_chain(torch.Generator().manual_seed(0), num_layers=8)
    chain.load_flat_params(
        {j: np.asarray(f) for j, f in ref_chain.flat_params().items()})
    data = wl.classification_batches("mlp", 8, batch=16, seed=0)
    port = live.run_live_training(chain, data, live.LiveConfig(
        num_workers=3, num_batches=B, protocol=ProtocolConfig(**PROTO),
        lr=0.1, device_specs=[DeviceSpec(n, c) for n, c in CAPS],
        bandwidth=uniform_bandwidth(3, 1e9),
        profile=WorkloadProfile(prof.fwd_times, prof.bwd_times,
                                prof.out_bytes, prof.weight_bytes),
        capacity_source="spec", kill=(1, 12), device="cpu"))
    return ref, port


@pytest.mark.live
def test_same_partitions_and_recovery(runs):
    ref, port = runs
    assert len(port.recoveries) == len(ref.recoveries) == 1
    assert len(port.partitions) >= 3          # initial, re-partition, recovery
    assert _points(port.partitions) == _points(ref.partitions)
    rr, pr = ref.recoveries[0], port.recoveries[0]
    assert pr["failed"] == rr["failed"] == [1]
    assert tuple(int(p) for p in pr["partition"]) == \
        tuple(int(p) for p in rr["partition"])


@pytest.mark.live
def test_losses_match_reference(runs):
    ref, port = runs
    restart = min(ref.recoveries[0]["restart"], port.recoveries[0]["restart"])
    assert restart >= 12
    np.testing.assert_allclose(port.losses[:restart], ref.losses[:restart],
                               rtol=1e-4, atol=1e-5)
    for res in (ref, port):
        assert np.isfinite(res.losses).all()
        assert res.losses[-5:].mean() < res.losses[:5].mean()


# ---------------------- int8-fused wire tier (K2/K3) ----------------------

FUSED_PROTO = dict(chain_every=4, global_every=8, repartition_first_at=10_000,
                   repartition_every=10_000, detect_timeout=2.0)


@pytest.fixture(scope="module")
def fused_runs():
    """The mlp chain (6 layers, 2 workers, 10 batches) on the wire codec:
    the JAX package on the int8-fused tier, and the port on the int8-fused
    and off tiers, all three on the JAX package's weights."""
    ref_chain = ref_wl.mlp_chain(jax.random.PRNGKey(0), num_layers=6)
    ref_data = ref_wl.classification_batches("mlp", 6, batch=16, seed=0)
    ref = ref_live.run_live_training(ref_chain, ref_data, ref_live.LiveConfig(
        num_workers=2, num_batches=10, protocol=RefProtocol(**FUSED_PROTO),
        lr=0.1, wire_codec=True, wire_compress="int8-fused",
        wire_compress_replica="off"))
    flats = {j: np.asarray(f) for j, f in ref_chain.flat_params().items()}

    def port(tier):
        chain = wl.mlp_chain(torch.Generator().manual_seed(0), num_layers=6)
        chain.load_flat_params(flats)
        data = wl.classification_batches("mlp", 6, batch=16, seed=0)
        return live.run_live_training(chain, data, live.LiveConfig(
            num_workers=2, num_batches=10,
            protocol=ProtocolConfig(**FUSED_PROTO), lr=0.1, wire_codec=True,
            wire_compress=tier, wire_compress_replica="off", device="cpu"))

    return ref, port("int8-fused"), port("off")


@pytest.mark.live
def test_fused_tier_losses_track_reference_and_exact_wire(fused_runs):
    ref, fused, off = fused_runs
    for res in fused_runs:
        assert len(res.losses) == 10 and np.isfinite(res.losses).all()
    # the port follows the JAX package's own fused run to f32 rounding
    # (1.2e-7 measured; the two differ only where the JAX CPU path
    # contracts lo + scale*q into an FMA). Dropping or negating the
    # residual moves the losses by about 4e-4, as does the off tier.
    assert float(np.max(np.abs(fused.losses - ref.losses))) <= 1e-5
    assert float(np.max(np.abs(fused.losses - off.losses))) <= 0.05


@pytest.mark.live
def test_fused_tier_ships_fewer_act_and_grad_bytes(fused_runs):
    _, fused, off = fused_runs
    kb1, kb0 = fused.transport_stats["kind_bytes"], \
        off.transport_stats["kind_bytes"]
    assert kb1["act"] + kb1["grad"] < 0.6 * (kb0["act"] + kb0["grad"])
    assert kb1["act"] < kb0["act"] and kb1["grad"] < kb0["grad"]
    assert kb0["control"] > 0 and kb1["control"] > 0
