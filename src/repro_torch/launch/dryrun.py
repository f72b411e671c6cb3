"""Dry run of every (architecture x input shape x mesh): trace one step of
the engine on meta stand-ins, count its FLOPs, and set the count beside
the analytic cost model and the H100 roofline.

The port of ``repro.launch.dryrun``. The JAX one lowers and compiles each
combo for 512 fake host devices and reads XLA's cost and memory analyses.
Here the step (``make_train_step``, ``make_prefill_step`` with chunked
caches, or ``make_serve_step``) runs once on meta tensors
(``launch/specs.py``) under ``compat.cost_analysis``: it allocates and
computes nothing, and the counter sees every matmul the step would issue
on the card (a K4 or K5 call as its plain version). Tracing on meta is
the counterpart of lowering on fake devices; it needs no GPU and hides
none. It traces the per-device program: one data shard's rows
(``Combo.B_loc``) on a mesh whose data axes are 1, stage and tensor
folded as the engine folds them, so the count over S x Tp is per device.

The report has the JAX report's keys. Those with no meaning here:
- ``lower_s`` is ``trace_s``: the wall time of the traced step;
- ``compile_s`` is null: nothing is compiled ahead of time;
- ``hlo_flops_raw`` is ``traced_flops_per_device``;
- ``hlo_bytes_raw``, ``hlo_collectives_raw`` are null: no HLO exists,
  and the one-device engine issues no collective;
- ``bytes_per_device``: ``arguments`` is ``specs.bytes_per_device`` of
  the step's inputs on the production mesh; ``output``, ``temp`` and
  ``code`` (XLA's buffer assignment) are null.
The cost-model fields (``flops_per_device``, ..., ``useful_ratio``) are
the JAX package's arithmetic over the H100 constants of ``analysis.py``.
Added: ``flops_per_device_ticks_m``, the analytic FLOPs with ticks = M
(the port's engine skips the JAX engine's M + S - 1 - M invalid ticks,
so this is the figure a traced count compares with). The Mamba2 scan
is counted at K5's chunk, as it runs on the card (``models/mamba2._chunk``).

    PYTHONPATH=src python -m repro_torch.launch.dryrun \\
        --arch qwen2-1.5b --shape train_4k
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import time
import traceback

from repro_torch import compat
from repro_torch.configs import (ARCH_IDS, SHAPES, TrainConfig, get_config,
                                 get_shape)
from repro_torch.launch import analysis
from repro_torch.launch import cost_model
from repro_torch.launch import specs as specs_lib
from repro_torch.launch.mesh import make_local_mesh, make_train_mesh
from repro_torch.pipeline.pipeline_step import (make_prefill_step,
                                                make_serve_step,
                                                make_train_step)
from repro_torch.pipeline.sharding import data_axes

OUT_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                       "build", "dryrun_torch")


def _local_mesh(mesh):
    """``mesh`` with its data axes at 1: one data shard's program."""
    data = set(data_axes(mesh))
    return make_local_mesh(
        [1 if a in data else n for a, n in zip(mesh.axis_names,
                                               mesh.axis_sizes)],
        mesh.axis_names, device="meta")


def trace_step(cfg, shape, mesh, B_loc: int, tc=None):
    """Trace one step of the per-device program of ``cfg`` x ``shape`` on
    ``mesh`` (a production train mesh, or any mesh whose data axes are
    then set to 1) on meta stand-ins, ``B_loc`` rows of the batch; a train
    step with ``tc`` (default: remat, SGD, the JAX dry run's). Returns
    (``compat.cost_analysis`` of it, the step's inputs' bytes per device
    on ``mesh``, trace seconds)."""
    local = _local_mesh(mesh)
    shape_l = dataclasses.replace(shape, global_batch=B_loc)
    t0 = time.perf_counter()
    if shape.kind == "train":
        tc = tc or TrainConfig(remat=True)
        step, _ = make_train_step(local, cfg, tc)
        state, state_sp = specs_lib.state_sds(cfg, mesh, tc)
        glob = specs_lib.train_batch_sds(cfg, shape, mesh)
        batch, _ = specs_lib.train_batch_sds(cfg, shape_l, local)
        cost = compat.cost_analysis(step, state, batch)
        args = [(state, state_sp), glob]
    elif shape.kind == "prefill":
        chunks = cfg.prefill_seq_chunks
        step = make_prefill_step(local, cfg, seq_chunks=chunks)
        params, params_sp = specs_lib.params_sds(cfg, mesh)
        glob = specs_lib.prefill_batch_sds(cfg, shape, mesh)
        batch, _ = specs_lib.prefill_batch_sds(cfg, shape_l, local)
        args = [(params, params_sp), glob]
        if chunks > 1:
            caches, _ = specs_lib.prefill_caches_sds(cfg, shape_l, local)
            cost = compat.cost_analysis(step, params, batch, caches)
            args.append(specs_lib.prefill_caches_sds(cfg, shape, mesh))
        else:
            cost = compat.cost_analysis(step, params, batch)
    else:
        glob, glob_sp = specs_lib.decode_inputs_sds(cfg, shape, mesh)
        dec, _ = specs_lib.decode_inputs_sds(cfg, shape_l, local)
        step = make_serve_step(local, cfg, data_sharded=glob["data_sharded"])
        params, params_sp = specs_lib.params_sds(cfg, mesh)
        extra = (dec["kv_source"],) if cfg.family == "audio" else ()
        cost = compat.cost_analysis(step, params, dec["token"],
                                    dec["caches"], dec["pos"], *extra)
        args = [(params, params_sp),
                ({k: glob[k] for k in glob_sp}, glob_sp)]
    trace_s = time.perf_counter() - t0
    arg_bytes = sum(specs_lib.bytes_per_device(t, sp, mesh)
                    for t, sp in args)
    return cost, arg_bytes, trace_s


def lower_combo(arch: str, shape_id: str, multi_pod: bool, overrides=None):
    """Trace one (arch x shape x mesh) combo on meta; returns the report."""
    cfg = get_config(arch)
    shape = get_shape(shape_id)
    cfg = specs_lib.shape_overrides(cfg, shape)
    if overrides:
        cfg = cfg.with_overrides(**overrides)
    mesh = make_train_mesh(cfg.pipeline_stages, cfg.tensor_parallel,
                           extra_data=cfg.extra_data, multi_pod=multi_pod,
                           device="meta")
    chips = math.prod(mesh.axis_sizes)
    combo = cost_model.Combo(cfg, shape, multi_pod=multi_pod)
    cost, arg_bytes, trace_s = trace_step(cfg, shape, mesh, combo.B_loc)
    folded = cfg.pipeline_stages * cfg.tensor_parallel
    cm = cost_model.roofline(combo)
    mf = analysis.model_flops(cfg, shape)
    flops_dev = cm["flops"]["total"]
    at_m = cost_model.Combo(cfg, shape, multi_pod=multi_pod)
    at_m.ticks = at_m.M
    traced = cost["flops"] / folded

    return {
        "arch": arch, "shape": shape_id,
        "mesh": "2x16x16" if multi_pod else "16x16",
        "chips": chips,
        "stage_x_tensor": [cfg.pipeline_stages, cfg.tensor_parallel],
        "microbatches": combo.M, "ticks": combo.ticks,
        "data_sharded": combo.data_sharded,
        "device": "meta",
        "trace_s": round(trace_s, 3), "compile_s": None,
        "traced_flops_per_device": traced,
        "hlo_bytes_raw": None,
        "hlo_collectives_raw": None,
        "bytes_per_device": {"arguments": arg_bytes, "output": None,
                             "temp": None, "code": None},
        "flops_per_device": cm["flops"],
        "flops_per_device_ticks_m": cost_model.flops_per_device(at_m),
        "collective_bytes_per_device": cm["collective_bytes"],
        "hbm_bytes_per_device": cm["hbm_bytes"],
        "roofline": cm["terms"],
        "dominant": cm["dominant"],
        "model_flops": mf,
        "useful_ratio": mf / (flops_dev * chips) if flops_dev else None,
    }


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--out", default=OUT_DIR)
    ap.add_argument("--set", default="",
                    help="config overrides for perf experiments, e.g. "
                         "pipeline_stages=4,tensor_parallel=1,extra_data=4")
    ap.add_argument("--tag", default="", help="suffix for the output json")
    args = ap.parse_args(argv)

    overrides = {}
    for kv in filter(None, args.set.split(",")):
        k, v = kv.split("=")
        overrides[k] = int(v) if v.lstrip("-").isdigit() else float(v)

    os.makedirs(args.out, exist_ok=True)
    archs = ARCH_IDS if (args.all or not args.arch) else [args.arch]
    shapes = list(SHAPES) if (args.all or not args.shape) else [args.shape]
    meshes = [False, True] if args.both_meshes else [args.multi_pod]

    failures = []
    for arch in archs:
        for shape_id in shapes:
            for mp in meshes:
                tag = f"{arch}_{shape_id}_{'2x16x16' if mp else '16x16'}"
                if args.tag:
                    tag += f"_{args.tag}"
                path = os.path.join(args.out, tag + ".json")
                if os.path.exists(path):
                    print(f"[skip] {tag} (cached)")
                    continue
                print(f"[trace on meta] {tag} ...", flush=True)
                try:
                    rep = lower_combo(arch, shape_id, mp, overrides)
                    with open(path, "w") as f:
                        json.dump(rep, f, indent=1)
                    r = rep["roofline"]
                    print(f"  OK trace={rep['trace_s']}s "
                          f"traced/dev={rep['traced_flops_per_device']:.3e} "
                          f"flops/dev={rep['flops_per_device']['total']:.3e} "
                          f"compute={r['compute_s']:.4f}s "
                          f"mem={r['memory_s']:.4f}s "
                          f"coll={r['collective_s']:.4f}s "
                          f"dom={rep['dominant']}", flush=True)
                except Exception as e:
                    failures.append((tag, repr(e)))
                    print(f"  FAIL {tag}: {e}")
                    traceback.print_exc()
    if failures:
        print(f"\n{len(failures)} FAILURES:")
        for t, e in failures:
            print(" ", t, e)
        raise SystemExit(1)
    print("\nall combos traced OK")


if __name__ == "__main__":
    main()
