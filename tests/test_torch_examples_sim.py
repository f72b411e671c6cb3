"""The port's simulator examples print what the JAX package's print, byte
for byte: ``examples_torch/heterogeneous_partition.py`` and
``fault_tolerance_demo.py`` against ``examples/`` (both packages'
simulators are numpy and share the protocol decisions, so the text is the
same to the last digit). And an example asked for CUDA where there is
none exits non-zero instead of falling back to the CPU."""
import pytest

torch = pytest.importorskip("torch")

from _torch_examples import JAX_EXAMPLES, PORT_EXAMPLES, run_script  # noqa: E402


@pytest.mark.parametrize("name", ["heterogeneous_partition",
                                  "fault_tolerance_demo"])
def test_simulator_example_prints_what_the_jax_one_prints(name):
    want = run_script(JAX_EXAMPLES / f"{name}.py")
    got = run_script(PORT_EXAMPLES / f"{name}.py", "--device", "cpu")
    assert want.returncode == 0, want.stderr[-2000:]
    assert got.returncode == 0, got.stderr[-2000:]
    assert want.stdout and got.stdout == want.stdout


def test_an_example_without_a_gpu_exits_non_zero_unless_told_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the no-fallback rule is "
                    "checked where there is none")
    proc = run_script(PORT_EXAMPLES / "heterogeneous_partition.py")
    assert proc.returncode != 0 and not proc.stdout
    assert "device='cpu'" in proc.stderr
