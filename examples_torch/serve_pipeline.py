"""Pipelined batched serving on the PyTorch port: decode a batch of
requests through the stage-partitioned model with per-stage KV caches
and SSM states (the decode path of every decode_32k / long_500k dry-run
shape).

The port of ``examples/serve_pipeline.py``: zamba2-7b reduced to 4
layers, 2 stages, tp 1 (a hybrid: attention KV caches AND Mamba2 state),
random weights from seed 0; 8 streams decode 24 steps from a 64-row
cache through ``make_serve_step``. The mesh is (data 2, stage 2, tensor
1), folded onto one device: the port's engine takes a tensor axis only as
wide as ``tensor_parallel``, where the JAX example's (2, 2, 2) mesh
replicates the model over its spare tensor axis, which computes the same
values. It computes on ``--device`` (default ``cuda``); without a GPU it
exits non-zero unless given ``--device cpu``. The speed it prints is the
device's, named with it (on a GPU, its name and power limit as
``nvidia-smi`` reports them).

    python examples_torch/serve_pipeline.py
    python examples_torch/serve_pipeline.py --device cpu
"""
import argparse
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "src"))

import torch

from repro_torch.configs import get_config
from repro_torch.launch.mesh import make_debug_mesh, mesh_context
from repro_torch.models import model as model_lib
from repro_torch.pipeline.pipeline_step import make_serve_step
from repro_torch.runtime.devices import resolve_device

BATCH, STEPS, CACHE_LEN = 8, 24, 64


def config():
    # hybrid arch: exercises attention KV caches AND mamba SSM state
    return get_config("zamba2-7b").reduced(pipeline_stages=2,
                                           tensor_parallel=1, num_layers=4)


def device_name(device) -> str:
    """The device a speed was measured on: a GPU's name and power limit
    (``nvidia-smi``), else its torch name."""
    if device.type != "cuda":
        return str(device)
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader", f"--id={torch.cuda.current_device()}"],
            capture_output=True, text=True, timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        out = ""
    return out or torch.cuda.get_device_name()


def decode(cfg, params, device, steps=STEPS, logits_out=None):
    """Greedy decode of ``BATCH`` streams from token 0 for ``steps``
    steps. Returns (streams, seconds); each step's logits are appended to
    ``logits_out`` when it is a list."""
    mesh = make_debug_mesh(data=2, stage=2, tensor=1, device=device)
    with mesh_context(mesh):
        caches = model_lib.init_caches(cfg, batch=BATCH, cache_len=CACHE_LEN,
                                       device=device)
        serve = make_serve_step(mesh, cfg)

        tok = torch.zeros((BATCH, 1), dtype=torch.int32, device=device)
        streams = [[] for _ in range(BATCH)]
        t0 = time.perf_counter()
        for pos in range(steps):
            logits, caches = serve(params, tok, caches, pos)
            if logits_out is not None:
                logits_out.append(logits)
            tok = torch.argmax(logits[:, -1], dim=-1)[:, None].to(
                torch.int32)
            for b, t in enumerate(tok[:, 0].tolist()):
                streams[b].append(int(t))
        dt = time.perf_counter() - t0
    return streams, dt


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="torch device (cuda or cpu); without a GPU only "
                         "--device cpu runs")
    args = ap.parse_args(argv)
    try:
        device = resolve_device(args.device)
    except RuntimeError as e:
        print(f"error: {e}", file=sys.stderr)
        return 1
    cfg = config()
    params = model_lib.init_params(0, cfg, device=device)
    streams, dt = decode(cfg, params, device)
    print(f"decoded {STEPS} tokens x {BATCH} streams in {dt:.1f}s "
          f"({STEPS*BATCH/dt:.0f} tok/s on {device_name(device)}, the "
          f"first call's set-up included)")
    for b in range(3):
        print(f"stream[{b}]: {streams[b]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
