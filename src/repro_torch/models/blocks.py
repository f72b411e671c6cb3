"""Slot blocks: the uniform per-layer interface of the transformer stacks.

The port of ``repro.models.blocks``, for the dense slot and the hybrid
family's ``mamba`` and ``hybrid`` slots. Every slot type implements:
    init(generator, cfg, dtype)                 -> params (full, unsharded)
    apply(p, x, ctx)                            -> (y, aux)      full-sequence
    init_cache(cfg, batch, cache_len, dtype)    -> cache
    step(p, x, cache, ctx)                      -> (y, new_cache) one token
    prefill_chunk(p, x, cache, ctx)             -> (y, new_cache) a chunk

Pad slots are realized by ``ctx.active``: ``active*y + (1-active)*x``, so a
padded slot is an exact identity. ``active`` is a Python float (JAX's weak
type: it keeps the activations' dtype) or a 0-d f32 tensor (a row of
``model.pad_mask``), which promotes bf16 activations to f32 as in JAX.
The other slot types of the JAX package (moe, mlstm, slstm, enc, dec) are
not ported yet and raise.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch import tree
from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn_lib
from repro_torch.models import mamba2 as m2
from repro_torch.models import modules
from repro_torch.models.tp import TP


@dataclasses.dataclass(frozen=True)
class BlockCtx:
    cfg: ModelConfig
    positions: Any = None          # [B, S] int32 (full-seq modes)
    pos: Any = None                # int or [B] int32 (decode); chunk start
    tp: TP = TP.none()
    dtype: Any = torch.bfloat16
    causal: bool = True
    window: int = 0                # sliding-window size (0 = full)
    kv_source: Any = None          # encoder output for cross-attention
    active: Any = 1.0              # pad-slot gate (0.0 or 1.0)


def _mlp_init(gen, cfg: ModelConfig, dtype, gated=True, d_ff=None):
    d, ff = cfg.d_model, d_ff or cfg.d_ff
    p = {"w_up": modules.dense_init(gen, d, ff, dtype=dtype),
         "w_down": modules.dense_init(gen, ff, d, dtype=dtype)}
    if gated:
        p["w_gate"] = modules.dense_init(gen, d, ff, dtype=dtype)
    return p


def _mlp(p, x, cfg, dtype):
    act = modules.activation(cfg.act)
    u = modules.dense(p["w_up"], x, dtype)
    if "w_gate" in p:
        u = act(modules.dense(p["w_gate"], x, dtype)) * u
    else:
        u = act(u)
    return modules.dense(p["w_down"], u, dtype)


def _promote(active, *xs):
    """JAX's promotion of ``active * x``: a 0-d f32 array is not weakly
    typed there, so it lifts bf16 operands to f32 (torch would keep bf16)."""
    if not torch.is_tensor(active):
        return (active, *xs)
    dt = active.dtype
    for x in xs:
        dt = torch.promote_types(dt, x.dtype)
    return (active.to(dt), *(x.to(dt) for x in xs))


def _blend(active, y, x):
    active, y, x = _promote(active, y, x)
    return active * y + (1.0 - active) * x


def _blend_cache(active, new, old):
    return tree.map(
        lambda a, b: (active * a.to(torch.float32)
                      + (1.0 - active) * b.to(torch.float32)).to(b.dtype),
        new, old)


# ------------------------------ dense -----------------------------------

class Dense:
    @staticmethod
    def init(gen, cfg, dtype=torch.float32):
        dev = gen.device
        return {"ln1": modules.norm_init(cfg.d_model, dtype=dtype, device=dev),
                "attn": attn_lib.init_attention(gen, cfg, dtype),
                "ln2": modules.norm_init(cfg.d_model, dtype=dtype, device=dev),
                "mlp": _mlp_init(gen, cfg, dtype)}

    @staticmethod
    def apply(p, x, ctx: BlockCtx):
        cfg = ctx.cfg
        a = attn_lib.attention(p["attn"],
                               modules.rmsnorm(p["ln1"], x, cfg.norm_eps),
                               cfg=cfg, positions=ctx.positions,
                               causal=ctx.causal, window=ctx.window,
                               tp=ctx.tp, dtype=ctx.dtype)
        x = _blend(ctx.active, x + ctx.tp.psum(a), x)
        mlp = _mlp(p["mlp"], modules.rmsnorm(p["ln2"], x, cfg.norm_eps), cfg,
                   ctx.dtype)
        x = _blend(ctx.active, x + ctx.tp.psum(mlp), x)
        return x, 0.0

    @staticmethod
    def init_cache(cfg, batch, cache_len, dtype=torch.bfloat16, device="cpu"):
        return {"attn": attn_lib.init_decode_cache(
            cfg, batch, cache_len, cfg.num_kv_heads, dtype, device)}

    @staticmethod
    def step(p, x, cache, ctx: BlockCtx):
        cfg = ctx.cfg
        a, nc = attn_lib.decode_attention(
            p["attn"], modules.rmsnorm(p["ln1"], x, cfg.norm_eps),
            cache["attn"], cfg=cfg, pos=ctx.pos, tp=ctx.tp, dtype=ctx.dtype)
        x = _blend(ctx.active, x + ctx.tp.psum(a), x)
        mlp = _mlp(p["mlp"], modules.rmsnorm(p["ln2"], x, cfg.norm_eps), cfg,
                   ctx.dtype)
        x = _blend(ctx.active, x + ctx.tp.psum(mlp), x)
        return x, {"attn": _blend_cache(ctx.active, nc, cache["attn"])}

    @staticmethod
    def prefill_chunk(p, x, cache, ctx: BlockCtx):
        cfg = ctx.cfg
        a, nc = attn_lib.chunk_attention(
            p["attn"], modules.rmsnorm(p["ln1"], x, cfg.norm_eps),
            cache["attn"], cfg=cfg, start=ctx.pos, tp=ctx.tp, dtype=ctx.dtype,
            window=ctx.window)
        x = _blend(ctx.active, x + ctx.tp.psum(a), x)
        mlp = _mlp(p["mlp"], modules.rmsnorm(p["ln2"], x, cfg.norm_eps), cfg,
                   ctx.dtype)
        x = _blend(ctx.active, x + ctx.tp.psum(mlp), x)
        return x, {"attn": _blend_cache(ctx.active, nc, cache["attn"])}


# ------------------------------ mamba -----------------------------------

class Mamba:
    @staticmethod
    def init(gen, cfg, dtype=torch.float32):
        return {"ln": modules.norm_init(cfg.d_model, dtype=dtype,
                                        device=gen.device),
                "mixer": m2.init_mamba2(gen, cfg, dtype)}

    @staticmethod
    def apply(p, x, ctx: BlockCtx):
        y = m2.mamba2_mixer(p["mixer"],
                            modules.rmsnorm(p["ln"], x, ctx.cfg.norm_eps),
                            cfg=ctx.cfg, dtype=ctx.dtype)
        return _blend(ctx.active, x + y, x), 0.0

    @staticmethod
    def init_cache(cfg, batch, cache_len, dtype=torch.bfloat16, device="cpu"):
        return {"mamba": m2.init_mamba2_cache(cfg, batch, device=device)}

    @staticmethod
    def step(p, x, cache, ctx: BlockCtx):
        y, nc = m2.mamba2_step(p["mixer"],
                               modules.rmsnorm(p["ln"], x, ctx.cfg.norm_eps),
                               cache["mamba"], cfg=ctx.cfg, dtype=ctx.dtype)
        return (_blend(ctx.active, x + y, x),
                {"mamba": _blend_cache(ctx.active, nc, cache["mamba"])})

    @staticmethod
    def prefill_chunk(p, x, cache, ctx: BlockCtx):
        y, nc = m2.mamba2_mixer_chunk(
            p["mixer"], modules.rmsnorm(p["ln"], x, ctx.cfg.norm_eps),
            cache["mamba"], cfg=ctx.cfg, dtype=ctx.dtype)
        return (_blend(ctx.active, x + y, x),
                {"mamba": _blend_cache(ctx.active, nc, cache["mamba"])})


# ------------------------------ hybrid ----------------------------------

class Hybrid:
    """zamba2 shared-attention slot: mamba2 mixer + attention + MLP."""

    @staticmethod
    def init(gen, cfg, dtype=torch.float32):
        dev = gen.device
        return {"mamba": Mamba.init(gen, cfg, dtype),
                "ln_a": modules.norm_init(cfg.d_model, dtype=dtype,
                                          device=dev),
                "attn": attn_lib.init_attention(gen, cfg, dtype),
                "ln_m": modules.norm_init(cfg.d_model, dtype=dtype,
                                          device=dev),
                "mlp": _mlp_init(gen, cfg, dtype)}

    @staticmethod
    def apply(p, x, ctx: BlockCtx):
        cfg = ctx.cfg
        x, _ = Mamba.apply(p["mamba"], x, ctx)
        a = attn_lib.attention(p["attn"],
                               modules.rmsnorm(p["ln_a"], x, cfg.norm_eps),
                               cfg=cfg, positions=ctx.positions,
                               causal=ctx.causal, window=ctx.window,
                               tp=ctx.tp, dtype=ctx.dtype)
        x = _blend(ctx.active, x + ctx.tp.psum(a), x)
        mlp = _mlp(p["mlp"], modules.rmsnorm(p["ln_m"], x, cfg.norm_eps), cfg,
                   ctx.dtype)
        x = _blend(ctx.active, x + ctx.tp.psum(mlp), x)
        return x, 0.0

    @staticmethod
    def init_cache(cfg, batch, cache_len, dtype=torch.bfloat16, device="cpu"):
        return {"mamba": m2.init_mamba2_cache(cfg, batch, device=device),
                "attn": attn_lib.init_decode_cache(
                    cfg, batch, cache_len, cfg.num_kv_heads, dtype, device)}

    @staticmethod
    def step(p, x, cache, ctx: BlockCtx):
        cfg = ctx.cfg
        y, ncm = m2.mamba2_step(
            p["mamba"]["mixer"],
            modules.rmsnorm(p["mamba"]["ln"], x, cfg.norm_eps),
            cache["mamba"], cfg=cfg, dtype=ctx.dtype)
        x = _blend(ctx.active, x + y, x)
        a, nca = attn_lib.decode_attention(
            p["attn"], modules.rmsnorm(p["ln_a"], x, cfg.norm_eps),
            cache["attn"], cfg=cfg, pos=ctx.pos, tp=ctx.tp, dtype=ctx.dtype)
        x = _blend(ctx.active, x + ctx.tp.psum(a), x)
        mlp = _mlp(p["mlp"], modules.rmsnorm(p["ln_m"], x, cfg.norm_eps), cfg,
                   ctx.dtype)
        x = _blend(ctx.active, x + ctx.tp.psum(mlp), x)
        return x, {"mamba": _blend_cache(ctx.active, ncm, cache["mamba"]),
                   "attn": _blend_cache(ctx.active, nca, cache["attn"])}

    @staticmethod
    def prefill_chunk(p, x, cache, ctx: BlockCtx):
        cfg = ctx.cfg
        y, ncm = m2.mamba2_mixer_chunk(
            p["mamba"]["mixer"],
            modules.rmsnorm(p["mamba"]["ln"], x, cfg.norm_eps),
            cache["mamba"], cfg=cfg, dtype=ctx.dtype)
        x = _blend(ctx.active, x + y, x)
        a, nca = attn_lib.chunk_attention(
            p["attn"], modules.rmsnorm(p["ln_a"], x, cfg.norm_eps),
            cache["attn"], cfg=cfg, start=ctx.pos, tp=ctx.tp, dtype=ctx.dtype,
            window=ctx.window)
        x = _blend(ctx.active, x + ctx.tp.psum(a), x)
        mlp = _mlp(p["mlp"], modules.rmsnorm(p["ln_m"], x, cfg.norm_eps),
                   cfg, ctx.dtype)
        x = _blend(ctx.active, x + ctx.tp.psum(mlp), x)
        return x, {"mamba": _blend_cache(ctx.active, ncm, cache["mamba"]),
                   "attn": _blend_cache(ctx.active, nca, cache["attn"])}


class _NotPorted:
    """A slot type of the JAX package that the port does not have yet."""

    def __init__(self, name):
        self.name = name

    def __getattr__(self, attr):
        raise NotImplementedError(
            f"slot type {self.name!r} is not ported yet (ROADMAP Queue 1 "
            f"item 11b): the port has the dense, mamba and hybrid slots")


BLOCKS = {"dense": Dense, "mamba": Mamba, "hybrid": Hybrid}
for _name in ("moe", "mlstm", "slstm", "enc", "dec"):
    BLOCKS[_name] = _NotPorted(_name)
