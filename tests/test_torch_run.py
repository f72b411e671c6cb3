"""The port's run facade (``repro_torch.run``), fleets
(``repro_torch.runtime.fleet``) and entry point
(``python -m repro_torch.launch.live_train``), after
``tests/test_durable.py`` and ``tests/test_fleet.py``: the manifest the
port writes equals the JAX package's for the same arguments (apart from
the port's ``device`` key) and round-trips; the CLI table matches the
parser; a durable queue run resumes cold with continuous losses;
``status``/``stop``; the fleet mean and the packed layer aggregate against
the reference on the same numpy snapshots (rtol 1e-6); fleets on the queue
transport and one queue-versus-TCP fleet round; and the CLI on the CPU,
with a real SIGKILL over TCP, and without a GPU. Everything runs with
``device="cpu"``; every wait is bounded."""
import dataclasses
import json
import os
import pathlib
import subprocess
import sys
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from repro import run as ref_run  # noqa: E402
from repro.runtime import fleet as ref_fleet  # noqa: E402
from repro.runtime import live as ref_live  # noqa: E402
from repro.runtime import protocol as ref_protocol  # noqa: E402
from repro.runtime import workload as ref_wl  # noqa: E402
from repro_torch.checkpoint.manifest import RunManifest  # noqa: E402
from repro_torch.core.stash import tree_mean  # noqa: E402
from repro_torch.launch.live_train import build_parser  # noqa: E402
from repro_torch.run import _ARG_MAP, Run, RunConfig, start_run  # noqa: E402
from repro_torch.runtime.fleet import (FleetAggregator, FleetConfig,  # noqa: E402
                                       FleetCoordinator, fleet_average,
                                       layer_aggregate_op)
from repro_torch.runtime.live import LiveConfig  # noqa: E402
from repro_torch.runtime.protocol import ProtocolConfig  # noqa: E402
from repro_torch.runtime.workload import WorkloadSpec  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]

# ------------------------------ the manifest ------------------------------

# (workload kwargs, live kwargs, protocol kwargs, fleet kwargs, transport)
MANIFEST_CASES = {
    "defaults": ({}, {}, {}, {}, "queue"),
    "mobilenet-tcp": ({"kind": "mobilenet", "seed": 3, "batch_size": 64},
                      {"num_workers": 3, "num_batches": 30, "lr": 0.005,
                       "momentum": 0.9, "wire_compress": "int8-fused",
                       "wire_compress_replica": "off", "reliable_data": True},
                      {"chain_every": 10, "global_every": 20,
                       "detect_timeout": 3.0}, {}, "tcp"),
    "fleet": ({"kind": "mlp", "seed": 1, "num_layers": 6},
              {"num_workers": 2, "num_batches": 12, "capacity_ema": 0.7,
               "overlap_replication": True, "repl_delta": "bytes"},
              {"refit_hysteresis": 0.25},
              {"chains": 2, "aggregate_every": 4, "min_chain_workers": 2,
               "chain_devices": ((1.0, 2.0), (1.0, 1.0))}, "queue"),
}


def _configs(case, device="cpu"):
    wk, lk, pk, fk, transport = MANIFEST_CASES[case]
    port = RunConfig(workload=WorkloadSpec(**wk),
                     live=LiveConfig(protocol=ProtocolConfig(**pk),
                                     device=device, **lk),
                     fleet=FleetConfig(**fk), transport=transport)
    ref = ref_run.RunConfig(
        workload=ref_wl.WorkloadSpec(**wk),
        live=ref_live.LiveConfig(protocol=ref_protocol.ProtocolConfig(**pk),
                                 **lk),
        fleet=ref_fleet.FleetConfig(**fk), transport=transport)
    return port, ref


@pytest.mark.parametrize("case", sorted(MANIFEST_CASES))
def test_manifest_equals_reference_and_round_trips(case):
    port, ref = _configs(case)
    doc = json.loads(json.dumps(port.to_manifest()))
    want = json.loads(json.dumps(ref.to_manifest()))
    assert doc["live"].pop("device") == "cpu"
    assert doc == want
    back = RunConfig.from_manifest(json.loads(json.dumps(
        port.to_manifest())))
    assert back == port and back.live.device == "cpu"


def test_legacy_v1_manifest_loads_as_single_chain():
    cfg = RunConfig(workload=WorkloadSpec(kind="mlp"),
                    live=LiveConfig(num_workers=3, num_batches=8))
    doc = json.loads(json.dumps(cfg.to_manifest()))
    doc.pop("fleet")
    doc["version"] = 1
    back = RunConfig.from_manifest(doc)
    assert back.fleet == FleetConfig() and back == cfg
    with pytest.raises(ValueError):
        RunConfig.from_manifest({**doc, "version": 99})


def test_fleet_config_round_trip_and_kill_chain_never_persisted():
    cfg = FleetConfig(chains=2, aggregate_every=7, barrier_timeout=30.0,
                      min_chain_workers=2, readmit=False,
                      chain_devices=((1.0, 2.0), (1.0, 1.0)),
                      kill_chain=(1, 9))
    doc = json.loads(json.dumps(cfg.to_doc()))
    assert "kill_chain" not in doc
    assert FleetConfig.from_doc(doc) == dataclasses.replace(cfg,
                                                            kill_chain=None)


CLI_LOCAL = {"kill", "rejoin", "join_after", "incarnation", "capacities",
             "resume", "role", "dev", "listen", "peers", "help"}


def test_arg_map_matches_live_train_parser():
    """Every ``_ARG_MAP`` row is a flag of the port's parser, every flag
    that configures the run has a row, and the reference's rows are all
    here (the port adds ``device``)."""
    dests = {a.dest for a in build_parser()._actions}
    assert not sorted(set(_ARG_MAP) - dests)
    assert not sorted(dests - set(_ARG_MAP) - CLI_LOCAL)
    assert set(_ARG_MAP) - set(ref_run._ARG_MAP) == {"device"}
    assert build_parser().parse_args([]).device == "cuda"
    ns = build_parser().parse_args(["--device", "cpu", "--chain",
                                    "mobilenet"])
    cfg = RunConfig.from_args(ns)
    assert cfg.live.device == "cpu" and cfg.workload.num_data_batches == 4


# ------------------------- durable runs, status, stop ---------------------

def _durable_config(run_dir, num_batches, lr=0.01):
    return RunConfig(
        workload=WorkloadSpec(kind="mlp", seed=0, num_layers=8),
        live=LiveConfig(
            num_workers=3, num_batches=num_batches, lr=lr,
            protocol=ProtocolConfig(chain_every=8, global_every=8,
                                    repartition_first_at=10_000,
                                    repartition_every=10_000,
                                    detect_timeout=2.0),
            run_dir=run_dir, device="cpu"))


@pytest.mark.live
def test_queue_cold_resume_loss_continuity(tmp_path):
    """A durable run stopped after its first commits resumes from the
    manifest, on the manifest's device, and tracks an uninterrupted run."""
    run_dir = str(tmp_path / "run")
    total = 24
    ref = start_run(_durable_config(None, total)).wait(timeout=120)
    start_run(_durable_config(run_dir, 16)).wait(timeout=120)
    m = RunManifest.load(run_dir)
    assert m.last_committed >= 0
    assert m.config["live"]["device"] == "cpu"
    resumed = Run.resume(run_dir, num_batches=total)
    start = resumed.config.live.start_batch
    assert start == m.last_committed + 1
    assert resumed.config.live.device == "cpu"
    res = resumed.start().wait(timeout=120)
    tail = [(b, l) for b, l in res.loss_log if b >= start]
    assert len(tail) == total - start
    div = max(abs(float(ref.losses[b]) - float(l)) for b, l in tail)
    assert div < 0.05, f"loss diverged across resume: {div}"


@pytest.mark.live
def test_resume_of_uncommitted_run_starts_fresh(tmp_path):
    run_dir = str(tmp_path / "run")
    start_run(_durable_config(run_dir, 4)).wait(timeout=120)
    resumed = Run.resume(run_dir, num_batches=6)
    assert resumed.config.live.start_batch == 0
    res = resumed.start().wait(timeout=120)
    assert not np.isnan(res.losses).any()


@pytest.mark.live
def test_run_status_and_stop(tmp_path):
    run = Run(_durable_config(str(tmp_path / "run"), 2000))
    assert run.status()["state"] == "created"
    started = threading.Event()
    run.start()
    for _ in range(3000):                        # bounded: <= 60 s
        if run.status()["batches_done"] >= 2:
            started.set()
            break
        started.wait(0.02)
    assert started.is_set()
    run.stop()                                  # wind down at a boundary
    res = run.wait(timeout=120)
    s = run.status()
    assert s["state"] == "finished" and s["transport"] == "queue"
    assert 2 <= len(res.loss_log) < 2000
    assert s["chains"][0]["progress"]["last_committed_manifest"] >= -1
    wire = s["wire"]
    wire["kind_bytes"]["act"] = -1               # a copy, not the counters
    assert run.status()["wire"]["kind_bytes"]["act"] != -1


# --------------------------------- fleets ---------------------------------

@pytest.mark.parametrize("chains,layers,width", [(1, 1, 1), (2, 3, 7),
                                                 (5, 6, 32)])
def test_fleet_average_matches_reference(chains, layers, width):
    rng = np.random.default_rng(chains * 100 + width)
    snaps = [{j: rng.normal(size=width).astype(np.float32)
              for j in range(layers)} for _ in range(chains)]
    got, want = fleet_average(snaps), ref_fleet.fleet_average(snaps)
    assert sorted(got) == sorted(want) == list(range(layers))
    for j in range(layers):
        assert isinstance(got[j], np.ndarray)
        np.testing.assert_allclose(got[j], want[j], rtol=1e-6)
        np.testing.assert_allclose(
            got[j], np.mean(np.stack([s[j] for s in snaps]), axis=0),
            rtol=1e-5, atol=1e-6)
    with pytest.raises(AssertionError):
        fleet_average([{0: np.zeros(3, np.float32)},
                       {1: np.zeros(3, np.float32)}])


def test_layer_aggregate_op_matches_reference_and_tree_mean():
    chain, _ = WorkloadSpec(kind="mlp", seed=3, num_layers=4).build(
        device="cpu")
    ref_chain, _ = ref_wl.WorkloadSpec(kind="mlp", seed=3,
                                       num_layers=4).build()
    rng = np.random.default_rng(0)
    versions = [[{k: rng.normal(size=tuple(v.shape)).astype(np.float32)
                  for k, v in p.items()} for p in chain.params]
                for _ in range(3)]
    op = layer_aggregate_op(chain.flat_layout())
    ref_op = ref_fleet.layer_aggregate_op(ref_chain.flat_layout())
    for j in range(chain.num_layers):
        trees = [{k: torch.tensor(a) for k, a in v[j].items()}
                 for v in versions]
        got, plain = op(j, trees), tree_mean(trees)
        want = ref_op(j, [v[j] for v in versions])
        for k in want:
            np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                       rtol=1e-6)
            np.testing.assert_allclose(got[k].numpy(), plain[k].numpy(),
                                       rtol=1e-5)


def _snap(val, layers=2):
    return {j: np.full(4, val, np.float32) for j in range(layers)}


def test_aggregator_round_degrade_and_readmit():
    agg = FleetAggregator(2, barrier_timeout=30.0)
    out = {}
    ts = [threading.Thread(target=lambda c, v: out.__setitem__(
        c, agg.aggregate(c, 5, _snap(v))), args=(c, v))
        for c, v in ((0, 1.0), (1, 3.0))]
    [t.start() for t in ts]
    [t.join(timeout=10) for t in ts]
    for cid in (0, 1):
        np.testing.assert_allclose(out[cid][0], np.full(4, 2.0))
    assert agg.rounds == [{"batch": 5, "contributors": [0, 1],
                           "degraded": []}]
    agg.chain_dead(1)
    assert agg.aggregate(0, 10, _snap(2.0)) is None     # solo round
    assert agg.latest_round()[0] == 10 and agg.live_chains() == [0]
    agg.chain_alive(1)
    assert agg.live_chains() == [0, 1]
    agg.close()
    assert agg.aggregate(0, 15, _snap(1.0)) is None     # closed


def test_fleet_rejects_resume_and_addr_of():
    cfg = RunConfig(workload=WorkloadSpec(kind="mlp"),
                    live=LiveConfig(num_workers=3, num_batches=8,
                                    device="cpu"),
                    fleet=FleetConfig(chains=2))
    run = Run(cfg)
    assert run.status()["fleet"]["chains"] == 2
    run._resume_state = {"last_committed": 3}
    with pytest.raises(RuntimeError, match="resume"):
        run._run_impl()
    with pytest.raises(RuntimeError, match="single-chain"):
        Run(cfg, addr_of={1: ("127.0.0.1", 1)})._run_impl()


def _live_cfg(batches=12, workers=3, **kw):
    return LiveConfig(num_workers=workers, num_batches=batches, lr=0.1,
                      protocol=ProtocolConfig(detect_timeout=2.0),
                      device="cpu", **kw)


@pytest.mark.live
def test_queue_fleet_two_chains_aggregates():
    spec = WorkloadSpec(kind="mlp", seed=0, num_data_batches=8)
    run = start_run(RunConfig(workload=spec, live=_live_cfg(batches=12),
                              fleet=FleetConfig(chains=2,
                                                aggregate_every=5)))
    res = run.wait(timeout=180)
    assert not res.chain_errors
    assert [r["batch"] for r in res.rounds] == [5, 10]
    assert all(r["contributors"] == [0, 1] for r in res.rounds)
    assert res.incarnations == {0: 1, 1: 1}
    assert np.isfinite(res.losses).all()
    assert res.final_flats and set(res.final_flats) == set(range(8))
    s = run.status()
    assert s["state"] == "finished" and s["fleet"]["rounds"] == 2
    assert s["batches_done"] == 12


@pytest.mark.live
def test_queue_tcp_fleet_round_parity():
    """The barrier decision is the pure ``aggregation_ready``: the same
    fleet config gives the same rounds on both transports."""
    spec = WorkloadSpec(kind="mlp", seed=0, num_data_batches=8)

    def rounds(transport):
        fc = FleetCoordinator(spec, _live_cfg(batches=8, workers=2),
                              FleetConfig(chains=2, aggregate_every=4),
                              transport=transport)
        res = fc.run()
        assert not res.chain_errors, res.chain_errors
        if transport == "tcp":
            assert res.exitcodes == {0: {1: {1: 0}}, 1: {1: {1: 0}}}
        return res.rounds

    assert rounds("queue") == rounds("tcp")


# ------------------------------- the CLI ----------------------------------

def _cli(*args, timeout=180):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               OMP_NUM_THREADS="2")
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.live_train", *args],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=timeout)


@pytest.mark.live
def test_cli_tcp_run_with_a_real_sigkill():
    proc = _cli("--device", "cpu", "--transport", "tcp", "--batches", "12",
                "--kill", "1@6", "--detect-timeout", "3.0")
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "transport=tcp" in proc.stdout
    assert "worker exit codes: {1: -9, 2: 0}" in proc.stdout
    assert "recovered: 2 workers" in proc.stdout


def test_cli_without_a_gpu_exits_before_training():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the no-fallback rule is "
                    "checked where there is none")
    for args in ((), ("--transport", "tcp")):
        proc = _cli("--batches", "4", *args, timeout=120)
        assert proc.returncode != 0
        assert "no CUDA device" in proc.stderr
        assert "live FTPipeHD run" not in proc.stdout
