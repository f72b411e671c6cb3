"""Batched pipelined serving entry point of the port: decodes tokens through
the stage-partitioned model with per-stage KV/SSM caches, through the
pipeline engine (``pipeline/pipeline_step.py``) on ``--device``
(default ``cuda``; without a GPU it exits non-zero unless given
``--device cpu``). The mesh is folded onto the device, or, under
``torchrun``, one process a position (as ``launch/train.py``): each rank
keeps its shards of the params and caches, every rank gets the whole
logits and samples the same tokens, and rank 0 prints.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-1.5b \
      --debug-mesh 2,2,2 --batch 8 --tokens 32
  PYTHONPATH=src torchrun --nproc-per-node 4 -m repro_torch.launch.serve \
      --device cpu --debug-mesh 1,2,2 --batch 4 --tokens 8
"""
import argparse
import sys
import time


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        description="Pipelined greedy or sampled decoding")
    ap.add_argument("--arch", default="qwen2-1.5b")
    ap.add_argument("--debug-mesh", default="2,2,2")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--tokens", type=int, default=32)
    ap.add_argument("--cache-len", type=int, default=128)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--device", default="cuda",
                    help="torch device (cuda or cpu); without a GPU only "
                         "--device cpu runs")
    return ap


def main(argv=None):
    args = build_parser().parse_args(argv)
    import torch

    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import (init_ranks_from_env,
                                         make_debug_mesh, mesh_context)
    from repro_torch.models import model as model_lib
    from repro_torch.pipeline.pipeline_step import make_serve_step
    from repro_torch.pipeline.sharding import shard_caches, shard_params

    dims = [int(x) for x in args.debug_mesh.split(",")]
    try:
        dev = init_ranks_from_env(args.device) or args.device
        mesh = make_debug_mesh(*dims, device=dev)
    except (RuntimeError, ValueError) as e:   # no CUDA device and no
        sys.exit(f"error: {e}")               # --device cpu; a bad world
    rank = getattr(mesh, "rank", None)
    dev = mesh.device
    cfg = get_config(args.arch).reduced(pipeline_stages=dims[1],
                                        tensor_parallel=dims[2])
    gen = torch.Generator(device=dev).manual_seed(0)
    with mesh_context(mesh), torch.no_grad():
        params = model_lib.init_params(gen, cfg, device=dev)
        layout = (cfg.decoder_slot_layout if cfg.family == "audio"
                  else cfg.slot_layout)
        caches = model_lib.init_caches(cfg, batch=args.batch,
                                       cache_len=args.cache_len,
                                       layout=layout, device=dev)
        if rank is not None:
            params = shard_params(params, mesh, cfg)
            caches = shard_caches(caches, mesh, cfg, layout)
        serve = make_serve_step(mesh, cfg)

        tok = torch.zeros((args.batch, 1), dtype=torch.int32, device=dev)
        outs = []
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        for pos in range(args.tokens):
            logits, caches = serve(params, tok, caches, pos)
            if args.temperature > 0:
                probs = torch.softmax(logits[:, -1] / args.temperature, -1)
                tok = torch.multinomial(probs, 1, generator=gen)
            else:
                tok = torch.argmax(logits[:, -1], dim=-1)[:, None]
            tok = tok.to(torch.int32)
            outs.append(tok[:, 0].cpu())
        dt = time.perf_counter() - t0
        name = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                else "cpu")
        where = "" if rank is None else f", {mesh.shape} ranks"
        if not rank:
            print(f"decoded {args.tokens} tokens x batch {args.batch} "
                  f"in {dt:.2f}s ({args.tokens * args.batch / dt:.1f} tok/s "
                  f"on {dev} ({name}){where}, reduced {cfg.name}, random "
                  f"weights)")
            print("sample stream[0]:", [int(o[0]) for o in outs])
    if rank is not None:
        import torch.distributed as dist
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
