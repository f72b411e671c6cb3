"""Quickstart on the PyTorch port: train a tiny pipelined LM on
synthetic data.

The port of ``examples/quickstart.py``, the public API in ~40 lines:
config -> mesh -> init -> pipelined train_step (1F1B + weight stash +
aggregation) -> loop. A 4-layer qwen2-family model with 2 pipeline stages
x 2-way tensor parallel on a (data 2, stage 2, tensor 2) mesh, which the
port's engine folds onto one device (``launch/mesh.LocalMesh``) where the
JAX example asks XLA for 8 host devices. Adam for 60 steps; the loss must
fall. It computes on ``--device`` (default ``cuda``); without a GPU it
exits non-zero unless given ``--device cpu``.

    python examples_torch/quickstart.py
    python examples_torch/quickstart.py --device cpu
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "src"))

import numpy as np
import torch

from repro_torch.configs import TrainConfig, get_config
from repro_torch.data.synthetic import SyntheticLM, lm_batches
from repro_torch.launch.mesh import make_debug_mesh, mesh_context
from repro_torch.models import model as model_lib
from repro_torch.pipeline.pipeline_step import make_train_step
from repro_torch.runtime.devices import resolve_device

STEPS = 60


def config():
    # a 4-layer qwen2-family model, 2 pipeline stages x 2-way tensor parallel
    return get_config("qwen2-1.5b").reduced(
        pipeline_stages=2, tensor_parallel=2, num_layers=4, vocab_size=256,
        aggregate_every=4, stash_depth=2)      # the paper's features, on


def train_config():
    return TrainConfig(learning_rate=0.02, optimizer="adam", microbatches=2,
                       weight_decay=0.0)


def train(cfg, params, device, steps=STEPS, log=print):
    """``steps`` train steps from ``params`` on the example's batches (8
    sequences of 32 tokens a step). Returns the losses."""
    mesh = make_debug_mesh(data=2, stage=2, tensor=2, device=device)
    with mesh_context(mesh):
        train_step, _ = make_train_step(mesh, cfg, train_config())
        state = train_step.init_state(params)

        ds = SyntheticLM(vocab_size=cfg.vocab_size)
        losses = []
        for i, (x, y) in enumerate(lm_batches(ds, batch=8, seq_len=32,
                                              num_batches=steps)):
            state, metrics = train_step(
                state, {"tokens": torch.as_tensor(x, device=device),
                        "labels": torch.as_tensor(y, device=device)})
            losses.append(float(metrics["loss"]))
            if i % 10 == 0:
                log(f"step {i:3d}  loss {losses[-1]:.4f}")
    return losses


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
    losses = train(cfg, params, device)
    print(f"\nloss: {np.mean(losses[:5]):.3f} -> {np.mean(losses[-5:]):.3f}")
    if not np.mean(losses[-5:]) < np.mean(losses[:5]):
        print("FAIL: the loss did not fall")
        return 1
    print("quickstart OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())
