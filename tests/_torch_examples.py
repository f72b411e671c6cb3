"""Helpers shared by the tests of the port's examples
(``tests/test_torch_examples_*.py``): load an example script of either
package as a module, and run one as a user starts it."""
import importlib.util
import os
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
JAX_EXAMPLES = ROOT / "examples"
PORT_EXAMPLES = ROOT / "examples_torch"


def load(name: str, port: bool):
    """The example ``name`` (``examples_torch/`` when ``port``, else
    ``examples/``) as a fresh module; its ``main`` is not run."""
    path = (PORT_EXAMPLES if port else JAX_EXAMPLES) / f"{name}.py"
    mod_name = f"{'port' if port else 'jax'}_example_{name}"
    spec = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def run_script(path, *args, timeout=300, env_extra=None):
    """``python <path> <args>`` from the repo root, the package on
    PYTHONPATH, with a bounded wait. Returns the CompletedProcess. Every
    process it starts computes with one intra-op thread (the demos'
    tensors are tiny; a thread a core in each of a demo's processes
    oversubscribes the CPU the test shares with other test files, and a
    worker descheduled past its detect timeout is taken for dead)."""
    env = dict(os.environ, JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join(
                   [str(ROOT / "src")]
                   + ([os.environ["PYTHONPATH"]]
                      if os.environ.get("PYTHONPATH") else [])),
               **(env_extra or {}))
    return subprocess.run([sys.executable, str(path), *args], cwd=ROOT,
                          env=env, capture_output=True, text=True,
                          timeout=timeout)
