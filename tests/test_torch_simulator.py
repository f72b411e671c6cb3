"""The port's timing simulator (``repro_torch.runtime.simulator``): the
cases of ``tests/test_simulator.py`` against the port's module, and its
parity with the JAX package's simulator. Both are numpy only and run the
same protocol code, so on the same ``SimConfig`` their batch times,
partitions, events and recovery overheads must be EQUAL, not close."""
import numpy as np
import pytest

from repro.runtime import devices as ref_dev
from repro.runtime import simulator as ref_sim
from repro_torch.runtime import devices as port_dev
from repro_torch.runtime import simulator as port_sim
from repro_torch.runtime.devices import (DeviceSpec, WorkloadProfile,
                                         uniform_bandwidth)
from repro_torch.runtime.simulator import (PipelineSimulator, SimConfig,
                                           single_device_time)


def _profile():
    return WorkloadProfile.mobilenetv2(batch=64)


def _sim(devs, policy="ftpipehd", n=300, **kw):
    return PipelineSimulator(SimConfig(devs, _profile(),
                                       uniform_bandwidth(len(devs)),
                                       policy=policy, num_batches=n, **kw))


def test_single_device_time():
    p = _profile()
    assert single_device_time(p, 1.0, 10) == pytest.approx(
        np.sum(p.exec_times) * 10)


def test_homogeneous_pipeline_beats_single_device():
    r = _sim(DeviceSpec.raspberry_trio()).run()
    assert r.total_time < single_device_time(_profile(), 1.0, 300)


def test_batch_completion_monotone_and_finite():
    r = _sim(DeviceSpec.paper_trio()).run()
    assert np.all(np.isfinite(r.batch_done))
    assert np.all(np.diff(r.batch_done) > 0)


def test_dynamic_partition_beats_static_under_heterogeneity():
    devs = DeviceSpec.paper_trio()
    ft = _sim(devs, "ftpipehd").run()
    pd = _sim(devs, "pipedream").run()
    assert ft.total_time < pd.total_time / 2
    counts = np.diff(np.concatenate([[-1], ft.partitions[-1][1]]))
    assert counts[2] <= counts[0]


def test_repartition_happens_at_batch_10():
    r = _sim(DeviceSpec.paper_trio()).run()
    reparts = [b for b, _ in r.partitions[1:]]
    assert reparts and reparts[0] == 10   # paper §III-D


def test_replication_spikes_in_batch_times():
    bt = _sim(DeviceSpec.raspberry_trio(), n=220).run().batch_times
    base = np.median(bt[20:45])
    assert bt[50] > base                  # chain replication at batch 50
    assert bt[100] > bt[50] * 0.99        # chain+global at 100 costs more


def test_fault_recovery_ftpipehd_vs_respipe():
    devs = DeviceSpec.paper_trio()
    ft = _sim(devs, "ftpipehd").run(fail=(1, 205))
    rp = _sim(devs, "respipe").run(fail=(1, 205))
    assert np.median(rp.batch_times[250:290]) > \
        2 * np.median(ft.batch_times[250:290])
    assert rp.recovery_overhead <= ft.recovery_overhead


def test_fault_of_last_worker():
    r = _sim(DeviceSpec.paper_trio(), "ftpipehd").run(fail=(2, 150))
    assert np.all(np.isfinite(r.batch_done))
    assert len(r.partitions[-1][1]) == 2  # two survivors


def test_faster_links_reduce_total_time():
    devs = DeviceSpec.paper_trio()
    slow, fast = (PipelineSimulator(SimConfig(
        devs, _profile(), uniform_bandwidth(3, bw), num_batches=100)).run()
        for bw in (1e6, 1e9))
    assert fast.total_time <= slow.total_time


def test_time_varying_capacity_adaptive_repartition():
    prof = _profile()
    devs = [DeviceSpec("central", 1.0),
            DeviceSpec("drifty", 1.0, capacity_schedule=((150, 5.0),)),
            DeviceSpec("steady", 1.0)]
    bw = uniform_bandwidth(3)
    ft = PipelineSimulator(SimConfig(devs, prof, bw, "ftpipehd",
                                     num_batches=400)).run()
    pd = PipelineSimulator(SimConfig(devs, prof, bw, "pipedream",
                                     num_batches=400)).run()
    post_ft = float(np.median(ft.batch_times[320:390]))
    assert post_ft < float(np.median(pd.batch_times[320:390])) * 0.5
    assert post_ft < float(np.median(ft.batch_times[100:145])) * 2.0
    assert any(b >= 200 for b, _ in ft.partitions[1:])


# ------------------------- parity with the reference ----------------------

# (devices as (name, capacity, capacity_schedule), policy, batches,
#  bandwidth, fail, extra SimConfig fields)
PARITY = {
    "hetero-fail": ((("central", 1.0, ()), ("peer", 2.5, ()),
                     ("slow", 6.0, ())), "ftpipehd", 240, 1e7, (1, 120),
                    {}),
    "drift-repartition": ((("central", 1.0, ()),
                           ("drifty", 1.0, ((60, 5.0),)),
                           ("steady", 1.5, ())), "ftpipehd", 200, 1e8,
                          None, {"repartition_first_at": 10,
                                 "repartition_every": 40}),
    "four-last-fails": ((("a", 1.0, ()), ("b", 3.0, ()), ("c", 1.0, ()),
                         ("d", 2.0, ())), "ftpipehd", 160, 5e6, (3, 90),
                        {"chain_every": 20, "global_every": 40}),
    "respipe-fail": ((("central", 1.0, ()), ("peer", 1.0, ()),
                      ("slow", 10.0, ())), "respipe", 200, 1e7, (1, 100),
                     {}),
    "pipedream": ((("central", 1.0, ()), ("peer", 1.0, ()),
                   ("slow", 10.0, ())), "pipedream", 120, 1e7, None, {}),
}


def _both(case):
    devs, policy, n, bw, fail, extra = PARITY[case]
    rng = np.random.default_rng(7)
    L = 12
    prof = dict(fwd_times=rng.uniform(1e-3, 5e-3, L),
                bwd_times=rng.uniform(2e-3, 1e-2, L),
                out_bytes=rng.uniform(1e4, 1e6, L).round(),
                weight_bytes=rng.uniform(1e3, 1e6, L).round())
    out = []
    for dev, sim in ((ref_dev, ref_sim), (port_dev, port_sim)):
        specs = [dev.DeviceSpec(name, cap, capacity_schedule=sch)
                 for name, cap, sch in devs]
        cfg = sim.SimConfig(specs, dev.WorkloadProfile(**prof),
                            dev.uniform_bandwidth(len(specs), bw),
                            policy=policy, num_batches=n, **extra)
        out.append(sim.PipelineSimulator(cfg).run(fail=fail))
    return out


@pytest.mark.parametrize("case", sorted(PARITY))
def test_simulator_equals_reference(case):
    ref, got = _both(case)
    np.testing.assert_array_equal(got.batch_done, ref.batch_done)
    np.testing.assert_array_equal(got.batch_times, ref.batch_times)
    assert got.total_time == ref.total_time
    assert got.recovery_overhead == ref.recovery_overhead
    assert got.events == ref.events
    assert [(b, tuple(int(p) for p in pts)) for b, pts in got.partitions] \
        == [(b, tuple(int(p) for p in pts)) for b, pts in ref.partitions]
    if PARITY[case][4] is not None:                  # a failure was run
        assert len(got.partitions[-1][1]) == len(PARITY[case][0]) - 1
        assert got.recovery_overhead > 0
