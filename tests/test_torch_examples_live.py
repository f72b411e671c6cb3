"""The port's live examples train the JAX examples' runs: every
``RunConfig`` a port example builds equals the one the JAX example
builds, as a manifest document (less ``device``, which only the port's
has) and in the settings a manifest leaves out (kill, rejoin, device
specs, bandwidth, netem, the fleet's chain kill). The JAX side is the
script itself, loaded by path with its ``start_run`` swapped for one
that records the config and stops. And the two demos whose workers are
threads run whole on the CPU, as a user starts them, and pass their own
checks."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from _torch_examples import PORT_EXAMPLES, load, run_script  # noqa: E402

# settings of LiveConfig that the manifest does not carry (the run
# module's _LIVE_SKIP, less those that only Run.resume assigns)
NOT_IN_MANIFEST = ("profile", "device_specs", "bandwidth", "fault", "kill",
                   "rejoin", "join_after", "netem", "kill_all_at")


class _Captured(Exception):
    pass


def _jax_configs(name, calls):
    """The RunConfigs the JAX example ``name`` builds: ``calls(mod)`` makes
    the calls its ``main`` makes, each stopped at ``start_run``."""
    mod = load(name, port=False)
    got = []

    def capture(cfg):
        got.append(cfg)
        raise _Captured

    mod.start_run = capture
    for call in calls(mod):
        with pytest.raises(_Captured):
            call()
    return got


def _plain(v):
    if v is None or isinstance(v, (bool, int, float, str)):
        return v
    if isinstance(v, (list, tuple)):
        return [_plain(x) for x in v]
    if isinstance(v, np.ndarray):
        return v.tolist()
    if hasattr(v, "to_doc"):
        return v.to_doc()
    if dataclasses.is_dataclass(v):
        return _plain(dataclasses.asdict(v))
    if isinstance(v, dict):
        return {k: _plain(x) for k, x in v.items()}
    raise TypeError(type(v))


def settings(cfg, port):
    """A RunConfig as plain data: its manifest document and the settings
    a manifest leaves out."""
    doc = cfg.to_manifest()
    if port:
        assert doc["live"].pop("device") == "cpu"
    doc["not_in_manifest"] = {k: _plain(getattr(cfg.live, k))
                              for k in NOT_IN_MANIFEST}
    doc["kill_chain"] = _plain(cfg.fleet.kill_chain)
    return doc


# an example whose main builds one config and starts it
SINGLE = (lambda m: [m.main], lambda m: [m.config("cpu")])


# example -> (the JAX example's calls, the port example's configs)
CASES = {
    "live_fault_tolerance": SINGLE,
    "live_wan_heterogeneity": SINGLE,
    "live_tcp_fault_tolerance": SINGLE,
    "live_elastic_rejoin": SINGLE,
    "live_compressed_wire": (
        lambda m: [lambda: m.run("off"), lambda: m.run("int8"),
                   lambda: m.run("off", kill=m.KILL, replica="off",
                                 transport="queue"),
                   lambda: m.run("int8-fused", kill=m.KILL, replica="off",
                                 transport="queue")],
        lambda m: [m.config("off", device="cpu"),
                   m.config("int8", device="cpu"),
                   m.config("off", kill=m.KILL, replica="off",
                            transport="queue", device="cpu"),
                   m.config("int8-fused", kill=m.KILL, replica="off",
                            transport="queue", device="cpu")]),
    "live_coordinator_failover": (
        lambda m: [lambda: m.start_run(m.make_config()),
                   lambda: m.start_run(m.make_config(run_dir="/run/dir",
                                                     transport="tcp"))],
        lambda m: [m.make_config(device="cpu"),
                   m.make_config(run_dir="/run/dir", transport="tcp",
                                 device="cpu")]),
    "live_fleet_chain_failure": (
        lambda m: [lambda: m.start_run(m.fleet_config(kill=True)),
                   lambda: m.start_run(m.fleet_config(kill=False))],
        lambda m: [m.fleet_config(True, "cpu"),
                   m.fleet_config(False, "cpu")]),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_live_example_configs_equal_the_jax_examples(name):
    jax_calls, port_configs = CASES[name]
    want = [settings(c, port=False) for c in _jax_configs(name, jax_calls)]
    got = [settings(c, port=True)
           for c in port_configs(load(name, port=True))]
    assert want and got == want


def test_live_example_constants_equal_the_jax_examples():
    """The constants a check or a schedule reads (kill and rejoin points,
    batch counts, loss tolerances, byte floors, commit to kill after)."""
    for name in sorted(CASES):
        jmod, pmod = load(name, port=False), load(name, port=True)
        names = [k for k in vars(jmod) if k.isupper()
                 and isinstance(getattr(jmod, k), (int, float, tuple))]
        assert names, name
        for k in names:
            assert getattr(pmod, k) == getattr(jmod, k), (name, k)


@pytest.mark.parametrize("name", ["live_fault_tolerance",
                                  "live_wan_heterogeneity"])
def test_in_process_demo_passes_on_the_cpu(name):
    """The two demos whose workers are threads, as a user starts them."""
    proc = run_script(PORT_EXAMPLES / f"{name}.py", "--device", "cpu")
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    assert proc.stdout.rstrip().endswith("PASS")
