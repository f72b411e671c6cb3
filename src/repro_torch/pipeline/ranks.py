"""Start one process a mesh position, and run functions on every rank.

The pipeline engine on ranks (``pipeline_step.py`` with a
``launch/mesh.RankMesh``) needs a ``torch.distributed`` world of one
process a mesh position. ``torchrun`` makes one for the entry points
(``launch/train.py``, ``launch/serve.py``); ``RankPool`` makes one from a
Python caller (tests, ``chip_smoke.py``):

- each rank is a process started with the ``spawn`` method (never
  ``fork``: the caller may hold threads, or JAX, that a forked child
  would inherit half-way);
- the ranks meet through a ``FileStore`` in a directory the caller
  passes, so no TCP port is taken and two pools never meet by mistake;
- ``init_process_group`` gets a bounded timeout, and each rank runs one
  torch thread on the CPU;
- ``run(fn, *args)`` calls ``fn(*args)`` on every rank (``fn`` must be
  importable by name, and should return plain data: numpy arrays,
  numbers, dicts) and returns the results in rank order; ``submit`` and
  ``result`` split it, so the caller can work while the ranks do;
- a rank that raises, dies or overruns the deadline fails the call: every
  rank is terminated and the parent raises ``RankError`` with the rank's
  traceback. No rank outlives the pool.

``run_ranks(fn, world, store_dir, *args)`` is a pool of one call.
"""
from __future__ import annotations

import datetime
import multiprocessing
import multiprocessing.connection
import os
import time
import traceback

_STOP = None


class RankError(RuntimeError):
    """A rank raised, died or did not answer in time."""


def _rank_main(rank: int, world: int, store_path: str, backend: str,
               device: str, timeout_s: float, numerics, conn):
    import torch
    import torch.distributed as dist

    from repro_torch.runtime.net import apply_numerics
    try:
        apply_numerics(numerics)
        if device == "cpu":
            torch.set_num_threads(1)
        else:
            torch.cuda.set_device(rank % torch.cuda.device_count())
        dist.init_process_group(
            backend, store=dist.FileStore(store_path, world), rank=rank,
            world_size=world,
            timeout=datetime.timedelta(seconds=timeout_s))
        conn.send(("ready", None))
    except Exception:
        conn.send(("error", traceback.format_exc()))
        return
    try:
        while True:
            try:
                msg = conn.recv()
            except EOFError:            # the parent has gone
                break
            if msg is _STOP:
                break
            fn, args, kwargs = msg
            try:
                out = ("ok", fn(*args, **kwargs))
            except Exception:
                out = ("error", traceback.format_exc())
            conn.send(out)
            if out[0] == "error":
                break
    finally:
        dist.destroy_process_group()


class RankPool:
    """``world`` rank processes in one process group (see the module
    docstring). ``device`` is "cpu" or "cuda" (rank r on GPU r modulo the
    count, so ranks share a GPU where there are fewer GPUs than ranks: gloo
    allows it, NCCL does not). ``timeout`` bounds the start-up, each
    ``run`` (unless it passes its own) and the process group's
    collectives."""

    GRACE_S = 5.0       # after one rank fails, how long to hear the others

    def __init__(self, world: int, store_dir: str, *, backend: str = "gloo",
                 device: str = "cpu", timeout: float = 120.0):
        from repro_torch.runtime.net import numerics_settings
        self.world, self.timeout = world, timeout
        os.makedirs(store_dir, exist_ok=True)
        store_path = os.path.join(store_dir, "rank_store")
        if os.path.exists(store_path):
            raise RankError(f"{store_path} exists: a pool needs a fresh "
                            f"directory")
        ctx = multiprocessing.get_context("spawn")
        self.conns, self.procs = [], []
        numerics = numerics_settings()
        for rank in range(world):
            parent, child = ctx.Pipe()
            p = ctx.Process(target=_rank_main, daemon=True, args=(
                rank, world, store_path, backend, device, timeout, numerics,
                child), name=f"rank{rank}")
            p.start()
            child.close()
            self.conns.append(parent)
            self.procs.append(p)
        self._collect(timeout, "start-up")

    def _collect(self, timeout: float, what: str) -> list:
        """Every rank's answer, in rank order, or ``RankError`` with what
        every failed rank said: those that fail within ``GRACE_S`` of the
        first are waited for (a rank that dies fails its peers'
        collectives, and either may be heard first)."""
        deadline = time.monotonic() + timeout
        out, errors = [None] * self.world, {}
        waiting = set(range(self.world))
        while waiting:
            left = deadline - time.monotonic()
            if left <= 0:
                break
            multiprocessing.connection.wait(
                [self.conns[r] for r in waiting]
                + [self.procs[r].sentinel for r in waiting], left)
            for r in sorted(waiting):
                try:
                    if self.conns[r].poll():
                        kind, value = self.conns[r].recv()
                    elif self.procs[r].is_alive():
                        continue
                    else:
                        raise EOFError
                except EOFError:            # it died without an answer
                    self.procs[r].join(5)
                    kind, value = "error", (f"its process exited with "
                                            f"code {self.procs[r].exitcode}")
                if kind == "error":
                    if not errors:
                        deadline = min(deadline,
                                       time.monotonic() + self.GRACE_S)
                    errors[r] = value
                else:
                    out[r] = value
                waiting.discard(r)
        if errors or waiting:
            self.close(force=True)
        if errors:
            raise RankError("\n".join(f"{what}: rank {r} failed:\n"
                                      f"{errors[r]}" for r in sorted(errors)))
        if waiting:
            raise RankError(f"{what}: ranks {sorted(waiting)} did not "
                            f"answer within {timeout:.0f} s")
        return out

    def submit(self, fn, *args, **kwargs):
        """Start ``fn(*args, **kwargs)`` on every rank; ``result()`` waits
        for it (the caller may work in between)."""
        if not self.procs:
            raise RankError("the pool is closed")
        for c in self.conns:
            c.send((fn, args, kwargs))
        self._pending = getattr(fn, "__name__", "run")

    def result(self, timeout: float | None = None) -> list:
        """The results of the last ``submit``, in rank order."""
        return self._collect(timeout or self.timeout, self._pending)

    def run(self, fn, *args, timeout: float | None = None, **kwargs) -> list:
        """``fn(*args, **kwargs)`` on every rank; the results in rank
        order."""
        self.submit(fn, *args, **kwargs)
        return self.result(timeout)

    def close(self, force: bool = False):
        """Stop every rank: asked to leave, then terminated, then killed,
        each step with a deadline."""
        if not self.procs:
            return
        if not force:
            for c in self.conns:
                try:
                    c.send(_STOP)
                except OSError:
                    pass
            for p in self.procs:
                p.join(10)
        for p in self.procs:
            if p.is_alive():
                p.terminate()
        for p in self.procs:
            p.join(5)
            if p.is_alive():
                p.kill()
                p.join(5)
        for c in self.conns:
            c.close()
        self.procs, self.conns = [], []

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close(force=exc[0] is not None)


def run_ranks(fn, world: int, store_dir: str, *args, backend: str = "gloo",
              device: str = "cpu", timeout: float = 120.0, **kwargs) -> list:
    """``fn(*args, **kwargs)`` on ``world`` fresh ranks; results in rank
    order (``RankPool`` says what fails the call)."""
    with RankPool(world, store_dir, backend=backend, device=device,
                  timeout=timeout) as pool:
        return pool.run(fn, *args, **kwargs)
