"""The launcher of the port's engine on ranks (``pipeline/ranks.py``)
and a one-rank world against the folded engine, on the CPU.

A ``RankPool`` spawns one process a rank, meets through a ``FileStore``
in the test's temporary directory and bounds every wait: a rank that
raises, dies or overruns fails the parent in bounded time with what the
rank said, and leaves no process behind. Two pools in one test process
do not meet. A one-rank world runs the engine's rank path (a
``RankMesh`` with every group of size one) and must equal the folded
engine bit for bit, as ``chip_smoke.py`` phase R holds it on the card.
"""
import threading
import time

import pytest

torch = pytest.importorskip("torch")

import _torch_rank_cases as rc  # noqa: E402
from repro_torch.pipeline.ranks import (RankError, RankPool,  # noqa: E402
                                        run_ranks)


def test_a_rank_that_raises_fails_the_parent_with_its_traceback(tmp_path):
    t0 = time.monotonic()
    with pytest.raises(RankError) as err:
        run_ranks(rc.fail_on, 3, str(tmp_path), 2, "rank two gives up",
                  timeout=60)
    assert time.monotonic() - t0 < 60
    msg = str(err.value)
    assert "rank 2 failed" in msg and "ValueError: rank two gives up" in msg
    assert "_torch_rank_cases.py" in msg          # the rank's traceback


def test_a_rank_that_dies_or_overruns_fails_the_parent(tmp_path):
    with pytest.raises(RankError,
                       match=r"rank 1 failed:\nits process exited with "
                             r"code 3"):
        run_ranks(rc.die, 2, str(tmp_path / "a"), 1, timeout=60)
    pool = RankPool(2, str(tmp_path / "b"), timeout=60)
    procs = list(pool.procs)
    t0 = time.monotonic()
    with pytest.raises(RankError, match="did not answer within 2 s"):
        pool.run(rc.sleep, 30, timeout=2)
    assert time.monotonic() - t0 < 20
    assert not any(p.is_alive() for p in procs)
    with pytest.raises(RankError, match="closed"):
        pool.run(rc.sleep, 0)


def test_two_pools_at_once_do_not_meet(tmp_path):
    """Two pools started and run at the same time from one process, each
    summing over its own world."""
    out = {}

    def go(name, world, x):
        out[name] = run_ranks(rc.rank_sum, world, str(tmp_path / name), x,
                              timeout=120)

    threads = [threading.Thread(target=go, args=("a", 2, 1.0)),
               threading.Thread(target=go, args=("b", 3, 10.0))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(180)
    assert not any(t.is_alive() for t in threads)
    assert out == {"a": [3.0, 3.0], "b": [60.0] * 3}
    with RankPool(1, str(tmp_path / "c"), timeout=60):
        with pytest.raises(RankError, match="fresh directory"):
            RankPool(1, str(tmp_path / "c"))


@pytest.mark.parametrize("arch,kw", [
    ("qwen2-1.5b", {"dtype": "bfloat16"}),
    ("olmoe-1b-7b", {"capacity_factor": 8.0, "router_aux_weight": 0.01})])
def test_one_rank_world_equals_the_folded_engine_bit_for_bit(tmp_path, arch,
                                                              kw):
    """Two Adam steps (4 microbatches, remat, stash 2) of the rank engine
    on a one-rank world and of the folded engine: the same losses and
    every leaf of the state (params, stash, moments, step) equal."""
    cfg_kw = dict(pipeline_stages=1, tensor_parallel=1, num_layers=2, **kw)
    (res,) = run_ranks(rc.train_bit_for_bit, 1, str(tmp_path), arch, cfg_kw,
                       2, 1e-3, timeout=240)
    assert not res["jax"]
    assert res["rank"] == res["folded"]
    assert res["same"] and res["leaves"] > 10


def test_a_mesh_must_have_the_world_size(tmp_path):
    with pytest.raises(RankError, match="the world has 2 ranks"):
        run_ranks(rc.mesh_of_wrong_size, 2, str(tmp_path), (1, 2, 2),
                  timeout=60)


def _losses(out: str):
    return [float(line.split()[-1]) for line in out.splitlines()
            if line.startswith("step ")]


def test_train_entry_point_under_torchrun_matches_the_folded_run():
    """``torchrun --nproc-per-node 2 -m repro_torch.launch.train`` on the
    CPU (gloo, a (1, 2, 1) mesh, one process a stage) prints the losses
    the folded run, started beside it, prints, within 2e-4 (the printed
    rounding): the first step's and the last's. Four steps with the
    blend every 2, so the last runs on step 2's blended weights."""
    import os
    import subprocess
    import sys

    from repro_torch.runtime.net import free_port
    # one torch thread a process: the test runs beside the suite's others
    env = {**os.environ, "OMP_NUM_THREADS": "1", "PYTHONPATH": os.pathsep.join(
        p for p in (os.path.join(os.path.dirname(__file__), "..", "src"),
                    os.environ.get("PYTHONPATH")) if p)}
    args = ["-m", "repro_torch.launch.train", "--device", "cpu",
            "--debug-mesh", "1,2,1", "--steps", "4", "--lr", "0.005",
            "--aggregate-every", "2"]
    runs = [subprocess.Popen(cmd, env=env, text=True,
                             stdout=subprocess.PIPE, stderr=subprocess.PIPE)
            for cmd in ([sys.executable, *args],
                        [sys.executable, "-m", "torch.distributed.run",
                         "--nproc-per-node", "2", "--master-addr",
                         "127.0.0.1", "--master-port", str(free_port()),
                         *args])]
    try:
        (f_out, f_err), (r_out, r_err) = (p.communicate(timeout=240)
                                          for p in runs)
    finally:
        for p in runs:
            p.kill()
            p.wait(10)
    assert runs[0].returncode == 0, f_err[-2000:]
    assert runs[1].returncode == 0, r_err[-2000:]
    assert "ranks (gloo)" in r_out
    want, got = _losses(f_out), _losses(r_out)
    assert len(got) == len(want) == 2
    assert got == pytest.approx(want, abs=2e-4)
