"""The port's training and serving entry points (``python -m
repro_torch.launch.train`` / ``.serve``) as a user starts them: on the CPU
with ``--device cpu``; without it, on a machine with no GPU, each exits
non-zero (neither falls back to the CPU on its own).

At the CLI's default lr (0.02, Adam) neither package's training improves
in 20 steps (``repro.launch.train --debug-mesh 1,2,1 --steps 20``:
6.7259 -> 6.9315; the port 6.6550 -> 6.9370), so these runs pass
``--lr 0.005`` (the JAX CLI there: 6.6916 -> 6.3164).
"""
import os
import pathlib
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

from repro_torch import tree  # noqa: E402
from repro_torch.checkpoint import CheckpointStore  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import model as M  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _run(*args, gpu_hidden=False, timeout=240):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="2")
    if gpu_hidden:
        env["CUDA_VISIBLE_DEVICES"] = ""
    return subprocess.run([sys.executable, "-m", *args], env=env,
                          capture_output=True, text=True, timeout=timeout)


def test_train_cli_on_the_cpu_improves():
    r = _run("repro_torch.launch.train", "--device", "cpu", "--debug-mesh",
             "1,2,1", "--steps", "20", "--lr", "0.005")
    assert r.returncode == 0, r.stderr[-2000:]
    assert "training qwen2-1.5b on cpu" in r.stdout, r.stdout
    assert "(improved)" in r.stdout, r.stdout


def test_train_cli_writes_a_checkpoint_that_restores(tmp_path):
    """The CLI saves the params every 50 steps, as the JAX CLI does."""
    r = _run("repro_torch.launch.train", "--device", "cpu", "--debug-mesh",
             "1,2,1", "--steps", "50", "--seq-len", "16", "--global-batch",
             "4", "--lr", "0.005", "--ckpt-dir", str(tmp_path))
    assert r.returncode == 0, r.stderr[-2000:]
    cfg = get_config("qwen2-1.5b").reduced(pipeline_stages=2,
                                           tensor_parallel=1,
                                           dtype="float32")
    like = M.init_params(0, cfg, device="cpu")
    restored, step = CheckpointStore(str(tmp_path)).restore_latest(like)
    assert step == 50
    for a, b in zip(tree.leaves(restored), tree.leaves(like)):
        assert a.shape == b.shape and bool(torch.isfinite(a).all())
    assert not torch.equal(restored["head"]["w"], like["head"]["w"])


def test_serve_cli_on_the_cpu():
    r = _run("repro_torch.launch.serve", "--device", "cpu", "--tokens", "8")
    assert r.returncode == 0, r.stderr[-2000:]
    assert "tok/s on cpu" in r.stdout and "sample stream[0]" in r.stdout


@pytest.mark.parametrize("module", ["repro_torch.launch.train",
                                    "repro_torch.launch.serve"])
def test_cli_without_a_gpu_exits_non_zero(module):
    r = _run(module, "--steps" if module.endswith("train") else "--tokens",
             "2", gpu_hidden=True, timeout=120)
    assert r.returncode != 0
    assert "no CUDA device" in r.stderr
