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
import dataclasses
import json

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
def measured():
    """The JAX package's mlp chain, its data and its measured profile: both
    runs of ``runs`` (and the simulator's prediction) use this profile."""
    ref_chain = ref_wl.mlp_chain(jax.random.PRNGKey(0), num_layers=8)
    ref_data = ref_wl.classification_batches("mlp", 8, batch=16, seed=0)
    return ref_chain, ref_data, ref_chain.measure_profile(ref_data[0],
                                                          repeats=2)


@pytest.fixture(scope="module")
def runs(measured):
    ref_chain, ref_data, prof = measured
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



# ------------------- the simulator's prediction (item 15) -----------------

@pytest.mark.live
def test_post_recovery_partition_matches_simulator_prediction(runs, measured):
    """The port's live run lands on the recovery partition that the port's
    ``PipelineSimulator`` predicts for the same failure, specs and profile
    (after ``tests/test_live_runtime.py``): both run the same
    ``runtime/protocol.py`` decisions."""
    from repro_torch.runtime.simulator import PipelineSimulator, SimConfig
    _, port = runs
    prof = measured[2]
    proto = ProtocolConfig(**PROTO)
    pred = PipelineSimulator(SimConfig(
        devices=[DeviceSpec(n, c) for n, c in CAPS],
        profile=WorkloadProfile(prof.fwd_times, prof.bwd_times,
                                prof.out_bytes, prof.weight_bytes),
        bandwidth=uniform_bandwidth(3, 1e9), num_batches=B,
        chain_every=proto.chain_every, global_every=proto.global_every,
        repartition_first_at=proto.repartition_first_at,
        repartition_every=proto.repartition_every)).run(fail=(1, 15))
    sim_points = _points(pred.partitions)
    assert len(port.recoveries) == 1
    assert _points(port.partitions)[-1] == sim_points[-1]
    assert tuple(int(p) for p in port.recoveries[0]["partition"]) \
        == sim_points[-1]


# ------------- live features held against the reference (item 14) ---------

def _fixed_profile(num_layers=8):
    """With spec capacities every control decision is a pure function of
    the config, so both packages must decide alike."""
    return dict(fwd_times=np.full(num_layers, 1e-3),
                bwd_times=np.full(num_layers, 2e-3),
                out_bytes=np.full(num_layers, 1024.0),
                weight_bytes=np.full(num_layers, 2048.0))


_PROTECT = ("hb", "hello", "install", "abort", "segment", "seg_done",
            "commit", "loss", "replicate", "replicated", "chain_put",
            "global_put", "fetch_req", "fetch_res", "repart", "recover",
            "ready", "probe", "probe_ack", "stop")
_WAN = {"default": {"latency": 0.003, "jitter": 0.001, "rate": 4e7},
        "seed": 3}

# feature -> (LiveConfig overrides, protocol overrides); "netem" and
# "fault" are built per package from the plain values here
FEATURES = {
    "overlap_replication": (dict(overlap_replication=True), {}),
    "rejoin": (dict(kill=(1, 6), rejoin=(1, 10), join_wait=30,
                    num_batches=18), dict(repartition_first_at=5)),
    "fp16": (dict(wire_codec=True, wire_compress="fp16"), {}),
    "int8": (dict(wire_codec=True, wire_compress="int8"), {}),
    "netem": (dict(netem=_WAN), dict(repartition_first_at=5)),
    "reliable_wire": (dict(reliable_data=True, rto=0.05,
                           fault=dict(drop=0.15, seed=5, protect=_PROTECT)),
                      {}),
}


def _feature_cfg(pkg, feature):
    """(LiveConfig, FaultSpec, NetemSpec classes...) of one package ->
    the feature's config: 3 workers with spec capacities (1, 1, 2) and a
    fixed profile, after ``tests/test_overlap.py::_det_cfg``."""
    live_mod, proto_cls, dev_mod, transport_mod, netem_mod = pkg
    kw, pkw = FEATURES[feature]
    kw = dict(kw)
    if "fault" in kw:
        kw["fault"] = transport_mod.FaultSpec(**kw["fault"])
    if "netem" in kw:
        kw["netem"] = netem_mod.NetemSpec.from_json(json.dumps(kw["netem"]))
    proto = dict(chain_every=4, global_every=8, repartition_first_at=10_000,
                 repartition_every=10_000, detect_timeout=2.0)
    proto.update(pkw)
    d = dict(num_workers=3, num_batches=12, protocol=proto_cls(**proto),
             lr=0.1,
             device_specs=[dev_mod.DeviceSpec("central", 1.0),
                           dev_mod.DeviceSpec("peer", 1.0),
                           dev_mod.DeviceSpec("slow", 2.0)],
             bandwidth=dev_mod.uniform_bandwidth(3, 1e9),
             profile=dev_mod.WorkloadProfile(**_fixed_profile()),
             capacity_source="spec")
    d.update(kw)
    return live_mod.LiveConfig(**d)


@pytest.mark.live
@pytest.mark.parametrize("feature", sorted(FEATURES))
def test_live_feature_matches_reference(feature):
    """One live feature on both packages from the JAX package's weights:
    the same partitions, recoveries and admissions; losses up to the
    restart (all of them without a failure) within rtol 1e-4, atol 1e-5;
    every batch finite."""
    from repro.runtime import devices as ref_dev
    from repro.runtime import netem as ref_netem
    from repro.runtime import transport as ref_transport
    from repro_torch.runtime import devices as dev
    from repro_torch.runtime import netem
    from repro_torch.runtime import transport
    ref_chain = ref_wl.mlp_chain(jax.random.PRNGKey(0), num_layers=8)
    ref_data = ref_wl.classification_batches("mlp", 8, batch=16, seed=0)
    ref = ref_live.run_live_training(ref_chain, ref_data, _feature_cfg(
        (ref_live, RefProtocol, ref_dev, ref_transport, ref_netem),
        feature))
    chain = wl.mlp_chain(torch.Generator().manual_seed(0), num_layers=8)
    chain.load_flat_params(
        {j: np.asarray(f) for j, f in ref_chain.flat_params().items()})
    data = wl.classification_batches("mlp", 8, batch=16, seed=0)
    cfg = _feature_cfg((live, ProtocolConfig, dev, transport, netem),
                       feature)
    port = live.run_live_training(chain, data,
                                  dataclasses.replace(cfg, device="cpu"))
    assert _points(port.partitions) == _points(ref.partitions)
    for key in ("failed", "partition"):
        assert [tuple(map(int, r[key])) for r in port.recoveries] == \
            [tuple(map(int, r[key])) for r in ref.recoveries]
    for key in ("devs", "incs", "partition"):
        assert [tuple(map(int, a[key])) for a in port.admissions] == \
            [tuple(map(int, a[key])) for a in ref.admissions]
    restart = min([r["restart"] for r in (*ref.recoveries,
                                          *port.recoveries)]
                  + [len(ref.losses)])
    np.testing.assert_allclose(port.losses[:restart], ref.losses[:restart],
                               rtol=1e-4, atol=1e-5)
    for res in (ref, port):
        assert np.isfinite(res.losses).all()
    if feature == "rejoin":
        assert port.admissions and port.admissions[0]["devs"] == [1]
        assert len(port.final_partition) == 3
    if feature == "reliable_wire":
        assert port.transport_stats["retransmits"] > 0
        assert not [e for _, e in port.events if "transient stall" in e]
    if feature in ("fp16", "int8"):
        kb, rkb = (port.transport_stats["kind_bytes"],
                   ref.transport_stats["kind_bytes"])
        assert kb["act"] == rkb["act"] and kb["grad"] == rkb["grad"]
