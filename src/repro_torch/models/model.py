"""Whole-model assembly: embeddings, stacked pipeline slots, head, and the
sequential (non-pipelined) forward and decode step.

The port of ``repro.models.model`` for every family of the JAX package:
dense (and ``vlm``, whose slots are dense), moe, ssm (xLSTM), hybrid
(zamba2) and audio (Whisper: an encoder stack over precomputed frame
embeddings, ``params["blocks"]``, and a decoder stack with
cross-attention, ``params["dec_blocks"]``), with its parameter layout:
  - Each pipeline stage holds ``layers_per_stage`` slots with a fixed,
    stage-uniform type layout.
  - Block params are stacked over a leading stage axis: leaf [S, ...];
    ``params["blocks"]`` is a list of slot dicts.
  - A partition assignment (per-stage active-layer counts) becomes a
    {0,1} pad mask of shape [S, Lps]. Pad slots run and are blended out
    (``blocks._blend``), as in the JAX package: zamba2-7b's assignment
    [6, 5, 5, ...] leaves slot 5 of stages 1-15 a pad, whose mixer still
    runs.
The sequential forward runs all S x Lps slots in order on one device;
the pipeline engine (``pipeline/pipeline_step.py``) runs them in its
stage schedule, microbatch by microbatch.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import tree
from repro_torch.configs.base import ModelConfig
from repro_torch.models import modules
from repro_torch.models.blocks import BLOCKS, BlockCtx
from repro_torch.runtime.devices import resolve_device


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


def decoder_assignment(cfg: ModelConfig) -> list[int]:
    S = cfg.pipeline_stages
    base, extra = divmod(cfg.decoder_layers, S)
    return [base + (1 if s < extra else 0) for s in range(S)]


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
    (pass ``device="cpu"`` to build on the CPU). ``device="meta"`` builds
    the tree's shapes and dtypes only: no draw, no memory. The draws
    cannot be the JAX package's: to run both on identical weights, use
    ``params_from_numpy``."""
    if device is not None and resolve_device(device).type == "meta":
        gen = modules.ShapeOnly()
    elif isinstance(seed_or_generator, torch.Generator):
        gen = seed_or_generator
        dev = gen.device if device is None else resolve_device(device)
        if gen.device.type != dev.type:
            raise ValueError(f"generator on {gen.device}, params on {dev}")
    else:
        dev = resolve_device(device)
        gen = torch.Generator(device=dev).manual_seed(int(seed_or_generator))
    S = cfg.pipeline_stages
    audio = cfg.family == "audio"
    params = {
        "embed": modules.embed_init(gen, cfg.padded_vocab, cfg.d_model,
                                    dtype),
        "blocks": _stack_init(cfg.slot_layout, gen, cfg, S, dtype),
        "final_norm": modules.norm_init(cfg.d_model, bias=audio, dtype=dtype,
                                        device=gen.device),
        "head": modules.dense_init(gen, cfg.d_model, cfg.padded_vocab,
                                   dtype=dtype),
    }
    if audio:
        params["dec_blocks"] = _stack_init(cfg.decoder_slot_layout, gen, cfg,
                                           S, dtype)
    return params


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


def embed_frames(cfg: ModelConfig, frames, dtype=torch.bfloat16):
    """Whisper encoder input: precomputed frame embeddings [B, F, d] +
    sinusoidal positions. Returns (x, positions [B, F])."""
    B, F, d = frames.shape
    pos = modules.sinusoidal_positions(F, d, frames.device)
    x = frames.to(dtype) + pos[None].to(dtype)
    positions = torch.arange(F, dtype=torch.int32,
                             device=frames.device).expand(B, F)
    return x, positions


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
    """Full LM forward (dense/moe/ssm/hybrid/vlm). Returns (logits, aux,
    mask)."""
    dtype = dtype or modules.dtype_of(cfg.dtype)
    x, positions, mask = embed(params, cfg, tokens, prefix=prefix,
                               dtype=dtype)
    ctx = BlockCtx(cfg=cfg, positions=positions, dtype=dtype,
                   window=window or cfg.sliding_window)
    pm = pad_mask(cfg, assignment, device=x.device)
    x, aux = forward_blocks(params["blocks"], cfg.slot_layout, x, ctx, pm)
    return head(params, cfg, x), aux, mask


def sequential_encdec_forward(params, cfg: ModelConfig, frames, tokens,
                              assignment=None, dtype=None):
    """Whisper: encoder over frames [B, F, d], decoder over tokens with
    cross-attention to the encoder's output. Returns (logits, 0.0,
    mask)."""
    dtype = dtype or modules.dtype_of(cfg.dtype)
    table = params["embed"]["table"]
    frames = torch.as_tensor(frames, device=table.device)
    xe, pos_e = embed_frames(cfg, frames, dtype)
    ctx_e = BlockCtx(cfg=cfg, positions=pos_e, dtype=dtype, causal=False)
    pm_e = pad_mask(cfg, assignment, device=xe.device)
    xe, _ = forward_blocks(params["blocks"], cfg.slot_layout, xe, ctx_e, pm_e)

    xd, pos_d, mask = embed(params, cfg, tokens, dtype=dtype)
    ctx_d = BlockCtx(cfg=cfg, positions=pos_d, dtype=dtype, kv_source=xe)
    pm_d = pad_mask(cfg, decoder_assignment(cfg), cfg.decoder_slot_layout,
                    device=xd.device)
    xd, _ = forward_blocks(params["dec_blocks"], cfg.decoder_slot_layout, xd,
                           ctx_d, pm_d)
    return head(params, cfg, xd), 0.0, mask


# ------------------------------- decode ---------------------------------

def init_caches(cfg: ModelConfig, batch: int, cache_len: int, layout=None,
                dtype=torch.bfloat16, device=None):
    """Stacked decode caches: per slot, leaves [S, ...] (stage-stacked).
    ``device`` defaults to CUDA and raises without it. For Whisper, pass
    ``layout=cfg.decoder_slot_layout``."""
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
    or a per-sequence [B] int tensor. Whisper's decoder reads the encoder's
    output from ``kv_source``. Returns (logits [B,1,V], new caches); the
    caches passed in are not written."""
    dtype = dtype or modules.dtype_of(cfg.dtype)
    table = params["embed"]["table"]
    token = torch.as_tensor(token, device=table.device).long()
    pos = torch.as_tensor(pos, dtype=torch.int32, device=table.device)
    x = table.to(dtype)[token]
    audio = cfg.family == "audio"
    if audio:
        pos_table = modules.sinusoidal_positions(cfg.max_target_positions,
                                                 cfg.d_model, x.device)
        x = x + pos_table[pos.long()].reshape(-1, 1, cfg.d_model).to(dtype)
    layout = cfg.decoder_slot_layout if audio else cfg.slot_layout
    blocks = params["dec_blocks"] if audio else params["blocks"]
    pm = pad_mask(cfg, assignment or (decoder_assignment(cfg) if audio
                                      else None), layout, device=x.device)
    S = pm.shape[0]
    new_caches = [tree.map(torch.clone, c) for c in caches]
    for s in range(S):
        for j, t in enumerate(layout):
            p = _slot_params(blocks[j], s)
            c_in = tree.map(lambda a: a[s], caches[j])
            ctx = BlockCtx(cfg=cfg, pos=pos, dtype=dtype, active=pm[s, j],
                           kv_source=kv_source, window=cfg.sliding_window)
            x, c_out = BLOCKS[t].step(p, x, c_in, ctx)
            for full, upd in zip(tree.leaves(new_caches[j]),
                                 tree.leaves(c_out)):
                full[s] = upd
    return head(params, cfg, x), new_caches
