"""``examples_torch/live_coordinator_failover.py`` as a user starts it,
on the CPU: a coordinator process SIGKILLed once the manifest commits
batch 7, ``Run.resume`` re-adopting the two surviving worker processes,
the resumed losses within 0.05 of an uninterrupted run. The demo checks
itself; it must exit 0 and end with PASS, within a bounded wait."""
import pytest

torch = pytest.importorskip("torch")

from _torch_examples import PORT_EXAMPLES, run_script  # noqa: E402


def test_coordinator_failover_demo_passes_on_the_cpu():
    proc = run_script(PORT_EXAMPLES / "live_coordinator_failover.py",
                      "--device", "cpu", timeout=600)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    assert proc.stdout.rstrip().endswith("PASS")
