"""``examples_torch/live_fleet_chain_failure.py`` as a user starts it,
on the CPU: two chains of a coordinator and two worker processes over
TCP, every worker of chain 1 SIGKILLed at batch 9, the fleet degraded to
chain 0 and chain 1 re-admitted, the final loss within 0.05 of an
unkilled fleet. The demo checks itself; it must exit 0 and end with
PASS, within a bounded wait."""
import pytest

torch = pytest.importorskip("torch")

from _torch_examples import PORT_EXAMPLES, run_script  # noqa: E402


def test_fleet_chain_failure_demo_passes_on_the_cpu():
    proc = run_script(PORT_EXAMPLES / "live_fleet_chain_failure.py",
                      "--device", "cpu", timeout=600)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    assert proc.stdout.rstrip().endswith("PASS")
