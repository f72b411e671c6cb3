"""End-to-end driver on the PyTorch port: train a ~100M-parameter
qwen2-family model through the whole stack (pipelined 1F1B, tensor
parallel, weight stash + aggregation, checkpointing).

The port of ``examples/train_e2e.py``. The default is the ~100M member
(12 layers, d 512, 8:2 heads of 64, d_ff 2,048, vocabulary 32,000, f32),
B=8, S=256, on a (data 2, stage 2, tensor 2) mesh that the port's engine
folds onto one device, with a checkpoint every 100 steps. ``--tiny``
trains a 4-layer, 512-token model at S <= 64 in seconds on the CPU. It
computes on ``--device`` (default ``cuda``); without a GPU it exits
non-zero unless given ``--device cpu``.

    python examples_torch/train_e2e.py --steps 200
    python examples_torch/train_e2e.py --tiny --steps 30 --device cpu
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "src"))

import numpy as np
import torch

from repro_torch.checkpoint import CheckpointStore
from repro_torch.configs import TrainConfig, get_config
from repro_torch.data.synthetic import SyntheticLM, lm_batches
from repro_torch.launch.mesh import make_debug_mesh, mesh_context
from repro_torch.models import model as model_lib
from repro_torch.models.modules import count_params
from repro_torch.pipeline.pipeline_step import make_train_step
from repro_torch.runtime.devices import resolve_device

CKPT_EVERY = 100


def config(tiny: bool):
    base = get_config("qwen2-1.5b")
    if tiny:
        return base.reduced(pipeline_stages=2, tensor_parallel=2,
                            num_layers=4, vocab_size=512)
    # ~100M-param family member: 12L, d=512, ff=2048, 32k vocab
    return base.with_overrides(
        num_layers=12, d_model=512, num_heads=8, num_kv_heads=2,
        head_dim=64, d_ff=2048, vocab_size=32_000,
        pipeline_stages=2, tensor_parallel=2, layers_per_stage=0,
        slot_layout=(), dtype="float32",
        aggregate_every=8, stash_depth=2)


def train_config():
    return TrainConfig(learning_rate=3e-4, optimizer="adam",
                       microbatches=2, weight_decay=0.0)


def train(cfg, params, device, batch, seq, steps, ckpt=None, log=print):
    """``steps`` train steps from ``params`` on the example's batches
    (``SyntheticLM`` with branching 16), a checkpoint of the params every
    ``CKPT_EVERY`` steps into ``ckpt`` (a ``CheckpointStore``, or None).
    Returns the losses."""
    mesh = make_debug_mesh(data=2, stage=2, tensor=2, device=device)
    with mesh_context(mesh):
        train_step, _ = make_train_step(mesh, cfg, train_config())
        state = train_step.init_state(params)
        ds = SyntheticLM(vocab_size=cfg.vocab_size, branching=16)
        losses = []
        for i, (x, y) in enumerate(lm_batches(ds, batch, seq, steps)):
            state, m = train_step(
                state, {"tokens": torch.as_tensor(x, device=device),
                        "labels": torch.as_tensor(y, device=device)})
            losses.append(float(m["loss"]))
            if i % 10 == 0:
                log(f"step {i:4d} loss {losses[-1]:.4f}")
            if ckpt is not None and (i + 1) % CKPT_EVERY == 0:
                ckpt.save(i + 1, state["params"])
    return losses


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--tiny", action="store_true")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--ckpt", default="/tmp/repro_torch_e2e_ckpt")
    ap.add_argument("--device", default="cuda",
                    help="torch device (cuda or cpu); without a GPU only "
                         "--device cpu runs")
    args = ap.parse_args(argv)
    try:
        device = resolve_device(args.device)
    except RuntimeError as e:
        print(f"error: {e}", file=sys.stderr)
        return 1
    cfg = config(args.tiny)
    if args.tiny:
        args.seq = min(args.seq, 64)
    params = model_lib.init_params(0, cfg, device=device)
    n = count_params(params)
    print(f"model: {cfg.name} variant, {n/1e6:.1f}M params, "
          f"{cfg.pipeline_stages} stages x {cfg.tensor_parallel} tp")
    ckpt = CheckpointStore(args.ckpt)
    losses = train(cfg, params, device, args.batch, args.seq, args.steps,
                   ckpt)
    print(f"\nloss {np.mean(losses[:5]):.4f} -> {np.mean(losses[-5:]):.4f}")
    print("checkpoints:", ckpt.steps())
    return 0


if __name__ == "__main__":
    sys.exit(main())
