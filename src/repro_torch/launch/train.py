"""End-to-end training entry point of the port.

Runs the stack (config -> init -> pipelined train step -> data ->
checkpoint) through the one-device engine (``pipeline/pipeline_step.py``)
on ``--device`` (default ``cuda``; without a GPU it exits non-zero unless
given ``--device cpu``: it never falls back to the CPU on its own).
``--debug-mesh`` is the (data, stage, tensor) mesh the engine schedules,
folded onto that device; reduced configs (the default) train a real small
model.

Examples:
  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-1.5b \
      --debug-mesh 2,2,2 --steps 50
  PYTHONPATH=src python -m repro_torch.launch.train --arch xlstm-125m \
      --steps 100 --aggregate-every 4
  PYTHONPATH=src python -m repro_torch.launch.train --device cpu \
      --debug-mesh 1,2,1 --steps 20
"""
import argparse
import sys


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        description="Pipelined LM training through the one-device engine")
    ap.add_argument("--arch", default="qwen2-1.5b")
    ap.add_argument("--reduced", action="store_true", default=True)
    ap.add_argument("--full", dest="reduced", action="store_false")
    ap.add_argument("--debug-mesh", default="2,2,2",
                    help="data,stage,tensor mesh folded onto the device")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=64)
    ap.add_argument("--lr", type=float, default=0.02)
    ap.add_argument("--optimizer", default="adam")
    ap.add_argument("--aggregate-every", type=int, default=0)
    ap.add_argument("--stash-depth", type=int, default=2)
    ap.add_argument("--microbatches", type=int, default=0)
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--device", default="cuda",
                    help="torch device (cuda or cpu); without a GPU only "
                         "--device cpu runs")
    return ap


def main(argv=None) -> bool:
    args = build_parser().parse_args(argv)
    import numpy as np
    import torch

    from repro_torch.checkpoint import CheckpointStore
    from repro_torch.configs import TrainConfig, get_config
    from repro_torch.data.synthetic import SyntheticLM, lm_batches
    from repro_torch.launch.mesh import make_debug_mesh, mesh_context
    from repro_torch.models import model as model_lib
    from repro_torch.pipeline.pipeline_step import make_train_step

    dims = [int(x) for x in args.debug_mesh.split(",")]
    try:
        mesh = make_debug_mesh(*dims, device=args.device)
    except RuntimeError as e:           # no CUDA device and no --device cpu
        sys.exit(f"error: {e}")
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced(pipeline_stages=dims[1], tensor_parallel=dims[2],
                          dtype="float32")
    cfg = cfg.with_overrides(aggregate_every=args.aggregate_every,
                             stash_depth=args.stash_depth)
    tc = TrainConfig(learning_rate=args.lr, optimizer=args.optimizer,
                     microbatches=args.microbatches, weight_decay=0.0)

    with mesh_context(mesh):
        print(f"training {cfg.name} on {mesh.device}", flush=True)
        params = model_lib.init_params(0, cfg, device=mesh.device)
        train_step, _ = make_train_step(mesh, cfg, tc)
        state = train_step.init_state(params)

        ds = SyntheticLM(vocab_size=cfg.vocab_size)
        ckpt = CheckpointStore(args.ckpt_dir) if args.ckpt_dir else None
        losses = []
        for i, (x, y) in enumerate(lm_batches(ds, args.global_batch,
                                              args.seq_len, args.steps)):
            state, metrics = train_step(
                state, {"tokens": torch.as_tensor(x, device=mesh.device),
                        "labels": torch.as_tensor(y, device=mesh.device)})
            losses.append(float(metrics["loss"]))
            if i % 10 == 0 or i == args.steps - 1:
                print(f"step {i:4d} loss {losses[-1]:.4f}", flush=True)
            if ckpt and (i + 1) % 50 == 0:
                ckpt.save(i + 1, state["params"])
        first = float(np.mean(losses[:5]))
        last = float(np.mean(losses[-5:]))
        print(f"loss {first:.4f} -> {last:.4f} "
              f"({'improved' if last < first else 'NOT improved'})",
              flush=True)
        return last < first


if __name__ == "__main__":
    main()
