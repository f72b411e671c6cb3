"""Stand-ins for every model input, per (architecture x input shape x
mesh), that allocate nothing.

The port of ``repro.launch.specs``. The JAX package's stand-ins are
``jax.ShapeDtypeStruct``s carrying a ``NamedSharding``; here each
``*_sds`` function returns a pair ``(tensors, specs)``: a tree of meta
tensors of the JAX stand-ins' shapes and dtypes, and beside it the tree
of partition specs (``pipeline/sharding.P``, per dimension the mesh
axes it is split over). ``bytes_per_device`` reads the two together.
Meta tensors hold no memory, so a full-width model's stand-ins cost
nothing to build, and the engine's steps run on them (``dryrun.py``).
"""
from __future__ import annotations

import math

import torch

from repro_torch import tree
from repro_torch.configs.base import InputShape, ModelConfig, TrainConfig
from repro_torch.models import model as model_lib
from repro_torch.pipeline.sharding import (P, cache_specs, data_axes,
                                           model_param_specs)

META = torch.device("meta")
_REPL = P()                     # replicated: a scalar's spec


def _meta(shape, dtype):
    return torch.empty(shape, dtype=dtype, device=META)


def shape_overrides(cfg: ModelConfig, shape: InputShape) -> ModelConfig:
    """Per-shape config adjustments (DESIGN.md §4): long-context decode gets
    a sliding window on every attention (SSM/hybrid state carries the long
    range); whisper's decoder is capped at its positional budget."""
    if shape.name == "long_500k" and cfg.family != "audio":
        if cfg.family not in ("ssm",):
            cfg = cfg.with_overrides(sliding_window=8192)
    return cfg


def decode_cache_len(cfg: ModelConfig, shape: InputShape) -> int:
    if cfg.family == "audio":
        return min(shape.seq_len, cfg.max_target_positions)
    if cfg.sliding_window:
        return min(shape.seq_len, cfg.sliding_window)
    return shape.seq_len


def batch_data_sharded(mesh, global_batch: int) -> bool:
    n = 1
    for a in data_axes(mesh):
        n *= mesh.shape[a]
    return global_batch % n == 0 and global_batch >= n


def bytes_per_device(tensors, specs, mesh) -> int:
    """The bytes one device holds of ``tensors`` laid out by ``specs`` on
    ``mesh``: each leaf's dimensions divided by the product of the mesh
    sizes its spec names for them (rounded up, as a shard's shape is), the
    port's counterpart of XLA's ``argument_size_in_bytes``."""
    total = 0
    # a spec P is a tuple, which the tree walk takes for one leaf
    for t, spec in zip(tree.leaves(tensors), tree.leaves(specs),
                       strict=True):
        dims = list(t.shape)
        for i, entry in enumerate(spec):
            axes = (entry,) if isinstance(entry, str) else (entry or ())
            n = math.prod(mesh.shape[a] for a in axes)
            dims[i] = -(-dims[i] // n)
        total += math.prod(dims) * t.element_size()
    return total


def params_sds(cfg: ModelConfig, mesh=None):
    """(params, specs): the shapes and dtypes of ``init_params``, built on
    the meta device (no draw, no memory)."""
    return (model_lib.init_params(0, cfg, device=META),
            model_param_specs(cfg))


def state_sds(cfg: ModelConfig, mesh, tc: TrainConfig):
    p, ps = params_sds(cfg, mesh)
    if tc.optimizer == "sgd":
        opt = ({"momentum": p}, {"momentum": ps})
    else:
        opt = ({"m": p, "v": p, "count": _meta((), torch.int32)},
               {"m": ps, "v": ps, "count": _REPL})
    return ({"params": p, "stash": p, "opt_state": opt[0],
             "step": _meta((), torch.int32)},
            {"params": ps, "stash": ps, "opt_state": opt[1],
             "step": _REPL})


def train_batch_sds(cfg: ModelConfig, shape: InputShape, mesh):
    dspec = data_axes(mesh)
    B, S = shape.global_batch, shape.seq_len
    tok = P(dspec, None)
    act = P(dspec, None, None)
    if cfg.family == "audio":
        return ({"frames": _meta((B, cfg.num_audio_frames, cfg.d_model),
                                 torch.bfloat16),
                 "tokens": _meta((B, S), torch.int32),
                 "labels": _meta((B, S), torch.int32)},
                {"frames": act, "tokens": tok, "labels": tok})
    batch, specs = {}, {}
    S_text = S
    if cfg.num_prefix_tokens:
        S_text = S - cfg.num_prefix_tokens
        batch["prefix"] = _meta((B, cfg.num_prefix_tokens, cfg.d_model),
                                torch.bfloat16)
        specs["prefix"] = act
    batch["tokens"] = _meta((B, S_text), torch.int32)
    batch["labels"] = _meta((B, S if cfg.num_prefix_tokens else S_text),
                            torch.int32)
    specs["tokens"] = specs["labels"] = tok
    return batch, specs


def decode_inputs_sds(cfg: ModelConfig, shape: InputShape, mesh):
    """(token, caches, pos, kv_source?) stand-ins for serve_step, and
    their specs: ``(inputs, specs)``; ``inputs["data_sharded"]`` is a
    bool."""
    sharded = batch_data_sharded(mesh, shape.global_batch)
    dspec = data_axes(mesh) if sharded else None
    B = shape.global_batch
    W = decode_cache_len(cfg, shape)
    layout = (cfg.decoder_slot_layout if cfg.family == "audio"
              else cfg.slot_layout)
    caches = model_lib.init_caches(cfg, batch=B, cache_len=W, layout=layout,
                                   dtype=torch.bfloat16, device=META)
    out = {"token": _meta((B, 1), torch.int32), "caches": caches,
           "pos": _meta((), torch.int32), "data_sharded": sharded}
    specs = {"token": P(dspec, None),
             "caches": [cache_specs(t, cfg, dspec) for t in layout],
             "pos": _REPL}
    if cfg.family == "audio":
        out["kv_source"] = _meta((B, cfg.num_audio_frames, cfg.d_model),
                                 torch.bfloat16)
        specs["kv_source"] = P(dspec, None, None)
    return out, specs


def prefill_batch_sds(cfg: ModelConfig, shape: InputShape, mesh):
    return train_batch_sds(cfg, shape, mesh)


def prefill_caches_sds(cfg: ModelConfig, shape: InputShape, mesh):
    """Stage-stacked caches sized for the full sequence (chunked
    prefill), and their specs."""
    dspec = data_axes(mesh)
    caches = model_lib.init_caches(cfg, batch=shape.global_batch,
                                   cache_len=shape.seq_len,
                                   dtype=torch.bfloat16, device=META)
    return caches, [cache_specs(t, cfg, dspec) for t in cfg.slot_layout]
