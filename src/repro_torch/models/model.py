"""Whole-model assembly: embeddings, stacked pipeline slots, head, and the
sequential (non-pipelined) forward and decode step.

The port of ``repro.models.model`` for the dense family (and ``vlm``,
whose slots are dense), with its parameter layout:
  - Each pipeline stage holds ``layers_per_stage`` slots with a fixed,
    stage-uniform type layout.
  - Block params are stacked over a leading stage axis: leaf [S, ...];
    ``params["blocks"]`` is a list of slot dicts.
  - A partition assignment (per-stage active-layer counts) becomes a
    {0,1} pad mask of shape [S, Lps].
The sequential forward runs all S x Lps slots in order on one device;
the pipeline engine that runs them across stages is ROADMAP Queue 1 item
12.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import tree
from repro_torch.configs.base import ModelConfig
from repro_torch.models import modules
from repro_torch.models.blocks import BLOCKS, BlockCtx
from repro_torch.runtime.devices import resolve_device


def _dense_family(cfg: ModelConfig):
    if cfg.family == "audio":
        raise NotImplementedError(
            "the audio family (Whisper enc/dec slots) is not ported yet "
            "(ROADMAP Queue 1 item 11)")


# --------------------------- layout helpers -----------------------------

def default_assignment(cfg: ModelConfig) -> list[int]:
    """Balanced contiguous per-stage layer counts (<= layers_per_stage)."""
    S, L, lps = cfg.pipeline_stages, cfg.num_layers, cfg.layers_per_stage
    if cfg.family == "audio":
        L = cfg.encoder_layers
    base, extra = divmod(L, S)
    counts = [base + (1 if s < extra else 0) for s in range(S)]
    assert all(c <= lps for c in counts), (counts, lps)
    return counts


def pad_mask(cfg: ModelConfig, assignment=None, layout=None,
             device="cpu") -> torch.Tensor:
    """[S, Lps] float32: 1 for active slots, 0 for pad."""
    assignment = assignment or default_assignment(cfg)
    lps = len(layout) if layout is not None else cfg.layers_per_stage
    m = np.zeros((cfg.pipeline_stages, lps), np.float32)
    for s, n in enumerate(assignment):
        m[s, :n] = 1.0
    return torch.as_tensor(m, device=device)


def global_layout(cfg: ModelConfig, assignment=None) -> list[str]:
    """Per-active-layer slot types in pipeline order."""
    assignment = assignment or default_assignment(cfg)
    out = []
    for n in assignment:
        out.extend(cfg.slot_layout[:n])
    return out


# ------------------------------- init -----------------------------------

def _stack_init(layout, gen, cfg, S, dtype):
    """Per-slot params stacked over the stage axis: list of pytrees [S,...]."""
    slots = []
    for t in layout:
        per_stage = [BLOCKS[t].init(gen, cfg, dtype) for _ in range(S)]
        slots.append(tree.map(lambda *xs: torch.stack(xs), *per_stage))
    return slots


def init_params(seed_or_generator, cfg: ModelConfig, dtype=torch.float32,
                device=None):
    """Random params from ``seed_or_generator`` (an int seed, or a
    ``torch.Generator`` on ``device``), deterministic in the seed on a
    given device type. ``device`` defaults to CUDA and raises without it
    (pass ``device="cpu"`` to build on the CPU). The draws cannot be the
    JAX package's: to run both on identical weights, use
    ``params_from_numpy``."""
    _dense_family(cfg)
    if isinstance(seed_or_generator, torch.Generator):
        gen = seed_or_generator
        dev = gen.device if device is None else resolve_device(device)
        if gen.device.type != dev.type:
            raise ValueError(f"generator on {gen.device}, params on {dev}")
    else:
        dev = resolve_device(device)
        gen = torch.Generator(device=dev).manual_seed(int(seed_or_generator))
    S = cfg.pipeline_stages
    return {
        "embed": modules.embed_init(gen, cfg.padded_vocab, cfg.d_model,
                                    dtype),
        "blocks": _stack_init(cfg.slot_layout, gen, cfg, S, dtype),
        "final_norm": modules.norm_init(cfg.d_model, dtype=dtype,
                                        device=gen.device),
        "head": modules.dense_init(gen, cfg.d_model, cfg.padded_vocab,
                                   dtype=dtype),
    }


def params_from_numpy(params, device="cpu"):
    """The JAX package's params as numpy (``jax.tree.map(np.asarray,
    params)``) -> the port's params: the same structure (dicts, the list of
    stacked slots), shapes, stacking and dtypes, as tensors on ``device``."""
    return tree.map(lambda a: torch.from_numpy(np.array(a)).to(device),
                    params)


# --------------------------- embed / head -------------------------------

def embed(params, cfg: ModelConfig, tokens, *, prefix=None,
          dtype=torch.bfloat16):
    """tokens: [B, S_text] int; prefix: [B, P, d] patch/frame embeddings.

    Returns (x [B, S_total, d], positions [B, S_total], loss_mask
    [B, S_total]).
    """
    table = params["embed"]["table"]
    tokens = torch.as_tensor(tokens, device=table.device).long()
    x = table.to(dtype)[tokens]
    mask = torch.ones(tokens.shape, dtype=torch.float32, device=table.device)
    if prefix is not None:
        x = torch.cat([prefix.to(dtype), x], dim=1)
        mask = torch.cat([torch.zeros(prefix.shape[:2], dtype=torch.float32,
                                      device=table.device), mask], dim=1)
    B, S = x.shape[:2]
    positions = torch.arange(S, dtype=torch.int32,
                             device=table.device).expand(B, S)
    if cfg.family == "audio":
        pos_table = modules.sinusoidal_positions(max(S, 2), cfg.d_model,
                                                 table.device)
        x = x + pos_table[None, :S].to(dtype)
    return x, positions, mask


def head(params, cfg: ModelConfig, x, dtype=torch.float32):
    xn = (modules.layernorm if cfg.family == "audio" else modules.rmsnorm)(
        params["final_norm"], x, cfg.norm_eps)
    return modules.dense(params["head"], xn, dtype)[..., :cfg.vocab_size]


# -------------------- sequential forward ------------------------------

def _slot_params(slot_stacked, s):
    return tree.map(lambda a: a[s], slot_stacked)


def forward_blocks(params_blocks, layout, x, ctx: BlockCtx, mask):
    """Run all S x Lps slots sequentially (the no-pipeline forward)."""
    S = mask.shape[0]
    aux = 0.0
    for s in range(S):
        for j, t in enumerate(layout):
            p = _slot_params(params_blocks[j], s)
            c = ctx.__class__(**{**ctx.__dict__, "active": mask[s, j]})
            x, a = BLOCKS[t].apply(p, x, c)
            aux = aux + a
    return x, aux


def sequential_lm_forward(params, cfg: ModelConfig, tokens, *, prefix=None,
                          assignment=None, dtype=None, window: int = 0):
    """Full LM forward (dense/vlm). Returns (logits, aux, mask)."""
    _dense_family(cfg)
    dtype = dtype or modules.dtype_of(cfg.dtype)
    x, positions, mask = embed(params, cfg, tokens, prefix=prefix,
                               dtype=dtype)
    ctx = BlockCtx(cfg=cfg, positions=positions, dtype=dtype,
                   window=window or cfg.sliding_window)
    pm = pad_mask(cfg, assignment, device=x.device)
    x, aux = forward_blocks(params["blocks"], cfg.slot_layout, x, ctx, pm)
    return head(params, cfg, x), aux, mask


# ------------------------------- decode ---------------------------------

def init_caches(cfg: ModelConfig, batch: int, cache_len: int, layout=None,
                dtype=torch.bfloat16, device=None):
    """Stacked decode caches: per slot, leaves [S, ...] (stage-stacked).
    ``device`` defaults to CUDA and raises without it."""
    _dense_family(cfg)
    dev = resolve_device(device)
    layout = layout or cfg.slot_layout
    S = cfg.pipeline_stages
    caches = []
    for t in layout:
        one = BLOCKS[t].init_cache(cfg, batch, cache_len, dtype, dev)
        caches.append(tree.map(
            lambda a: a[None].expand((S,) + tuple(a.shape)).clone(), one))
    return caches


def sequential_decode_step(params, cfg: ModelConfig, token, caches, pos, *,
                           kv_source=None, assignment=None, dtype=None):
    """One-token decode through all slots. token: [B,1] int; pos: an int
    or a per-sequence [B] int tensor. Returns (logits [B,1,V], new caches);
    the caches passed in are not written."""
    _dense_family(cfg)
    dtype = dtype or modules.dtype_of(cfg.dtype)
    table = params["embed"]["table"]
    token = torch.as_tensor(token, device=table.device).long()
    pos = torch.as_tensor(pos, dtype=torch.int32, device=table.device)
    x = table.to(dtype)[token]
    layout = cfg.slot_layout
    pm = pad_mask(cfg, assignment, layout, device=x.device)
    S = pm.shape[0]
    new_caches = [tree.map(torch.clone, c) for c in caches]
    for s in range(S):
        for j, t in enumerate(layout):
            p = _slot_params(params["blocks"][j], s)
            c_in = tree.map(lambda a: a[s], caches[j])
            ctx = BlockCtx(cfg=cfg, pos=pos, dtype=dtype, active=pm[s, j],
                           kv_source=kv_source, window=cfg.sliding_window)
            x, c_out = BLOCKS[t].step(p, x, c_in, ctx)
            for full, upd in zip(tree.leaves(new_caches[j]),
                                 tree.leaves(c_out)):
                full[s] = upd
    return head(params, cfg, x), new_caches
