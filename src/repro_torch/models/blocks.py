"""Slot blocks: the uniform per-layer interface of the transformer stacks.

The port of ``repro.models.blocks``, with all of its slot types: dense,
moe, mamba, hybrid, mlstm, slstm, and Whisper's enc and dec. Every slot
type implements:
    init(generator, cfg, dtype)                 -> params (full, unsharded)
    apply(p, x, ctx)                            -> (y, aux)      full-sequence
    init_cache(cfg, batch, cache_len, dtype)    -> cache
    step(p, x, cache, ctx)                      -> (y, new_cache) one token
    prefill_chunk(p, x, cache, ctx)             -> (y, new_cache) a chunk

Pad slots are realized by ``ctx.active``: ``active*y + (1-active)*x``, so a
padded slot is an exact identity. ``active`` is a Python float (JAX's weak
type: it keeps the activations' dtype) or a 0-d f32 tensor (a row of
``model.pad_mask``), which promotes bf16 activations to f32 as in JAX.
As in the JAX package, the encoder slot has no decode step and the
decoder slot no ``prefill_chunk``.
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
from repro_torch.models import moe as moe_lib
from repro_torch.models import xlstm
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


# ------------------------------- moe ------------------------------------

class Moe:
    @staticmethod
    def init(gen, cfg, dtype=torch.float32):
        dev = gen.device
        return {"ln1": modules.norm_init(cfg.d_model, dtype=dtype, device=dev),
                "attn": attn_lib.init_attention(gen, cfg, dtype),
                "ln2": modules.norm_init(cfg.d_model, dtype=dtype, device=dev),
                "moe": moe_lib.init_moe(gen, cfg, dtype)}

    @staticmethod
    def _ffn(p, x, ctx: BlockCtx):
        """The MoE half: returns (x after its residual, aux)."""
        cfg = ctx.cfg
        y, aux = moe_lib.moe_ffn(p["moe"],
                                 modules.rmsnorm(p["ln2"], x, cfg.norm_eps),
                                 cfg=cfg, tp=ctx.tp, dtype=ctx.dtype)
        return _blend(ctx.active, x + ctx.tp.psum(y), x), aux

    @staticmethod
    def apply(p, x, ctx: BlockCtx):
        cfg = ctx.cfg
        a = attn_lib.attention(p["attn"],
                               modules.rmsnorm(p["ln1"], x, cfg.norm_eps),
                               cfg=cfg, positions=ctx.positions,
                               causal=ctx.causal, window=ctx.window,
                               tp=ctx.tp, dtype=ctx.dtype)
        x = _blend(ctx.active, x + ctx.tp.psum(a), x)
        x, aux = Moe._ffn(p, x, ctx)
        return x, aux * ctx.active

    @staticmethod
    def init_cache(cfg, batch, cache_len, dtype=torch.bfloat16, device="cpu"):
        return Dense.init_cache(cfg, batch, cache_len, dtype, device)

    @staticmethod
    def step(p, x, cache, ctx: BlockCtx):
        cfg = ctx.cfg
        a, nc = attn_lib.decode_attention(
            p["attn"], modules.rmsnorm(p["ln1"], x, cfg.norm_eps),
            cache["attn"], cfg=cfg, pos=ctx.pos, tp=ctx.tp, dtype=ctx.dtype)
        x = _blend(ctx.active, x + ctx.tp.psum(a), x)
        x, _ = Moe._ffn(p, x, ctx)
        return x, {"attn": _blend_cache(ctx.active, nc, cache["attn"])}

    @staticmethod
    def prefill_chunk(p, x, cache, ctx: BlockCtx):
        cfg = ctx.cfg
        a, nc = attn_lib.chunk_attention(
            p["attn"], modules.rmsnorm(p["ln1"], x, cfg.norm_eps),
            cache["attn"], cfg=cfg, start=ctx.pos, tp=ctx.tp, dtype=ctx.dtype,
            window=ctx.window)
        x = _blend(ctx.active, x + ctx.tp.psum(a), x)
        x, _ = Moe._ffn(p, x, ctx)
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


# ---------------------------- mLSTM/sLSTM -------------------------------

class MLstm:
    @staticmethod
    def init(gen, cfg, dtype=torch.float32):
        return {"ln": modules.norm_init(cfg.d_model, dtype=dtype,
                                        device=gen.device),
                "mixer": xlstm.init_mlstm(gen, cfg, dtype)}

    @staticmethod
    def apply(p, x, ctx: BlockCtx):
        y = xlstm.mlstm_mixer(p["mixer"],
                              modules.rmsnorm(p["ln"], x, ctx.cfg.norm_eps),
                              cfg=ctx.cfg, dtype=ctx.dtype, tp=ctx.tp)
        return _blend(ctx.active, x + ctx.tp.psum(y), x), 0.0

    @staticmethod
    def init_cache(cfg, batch, cache_len, dtype=torch.bfloat16, device="cpu"):
        return {"mlstm": xlstm.init_mlstm_cache(cfg, batch, device=device)}

    @staticmethod
    def step(p, x, cache, ctx: BlockCtx):
        y, nc = xlstm.mlstm_step(
            p["mixer"], modules.rmsnorm(p["ln"], x, ctx.cfg.norm_eps),
            cache["mlstm"], cfg=ctx.cfg, dtype=ctx.dtype, tp=ctx.tp)
        return (_blend(ctx.active, x + ctx.tp.psum(y), x),
                {"mlstm": _blend_cache(ctx.active, nc, cache["mlstm"])})

    @staticmethod
    def prefill_chunk(p, x, cache, ctx: BlockCtx):
        y, nc = xlstm.mlstm_mixer_chunk(
            p["mixer"], modules.rmsnorm(p["ln"], x, ctx.cfg.norm_eps),
            cache["mlstm"], cfg=ctx.cfg, dtype=ctx.dtype, tp=ctx.tp)
        return (_blend(ctx.active, x + ctx.tp.psum(y), x),
                {"mlstm": _blend_cache(ctx.active, nc, cache["mlstm"])})


class SLstm:
    """The cache is ``{"slstm": {c, n, h, m}}``; ``step`` and
    ``prefill_chunk`` blend the whole cache dict, as the JAX package's."""

    @staticmethod
    def init(gen, cfg, dtype=torch.float32):
        return {"ln": modules.norm_init(cfg.d_model, dtype=dtype,
                                        device=gen.device),
                "mixer": xlstm.init_slstm(gen, cfg, dtype)}

    @staticmethod
    def apply(p, x, ctx: BlockCtx):
        y = xlstm.slstm_mixer(p["mixer"],
                              modules.rmsnorm(p["ln"], x, ctx.cfg.norm_eps),
                              cfg=ctx.cfg, dtype=ctx.dtype, tp=ctx.tp)
        return _blend(ctx.active, x + ctx.tp.psum(y), x), 0.0

    @staticmethod
    def init_cache(cfg, batch, cache_len, dtype=torch.bfloat16, device="cpu"):
        c, n, h, m = xlstm.init_slstm_state(cfg, batch, device=device)
        return {"slstm": {"c": c, "n": n, "h": h, "m": m}}

    @staticmethod
    def step(p, x, cache, ctx: BlockCtx):
        st = tuple(cache["slstm"][k] for k in ("c", "n", "h", "m"))
        y, st2 = xlstm.slstm_step(
            p["mixer"], modules.rmsnorm(p["ln"], x, ctx.cfg.norm_eps), st,
            cfg=ctx.cfg, dtype=ctx.dtype, tp=ctx.tp)
        nc = {"slstm": dict(zip(("c", "n", "h", "m"), st2))}
        return (_blend(ctx.active, x + ctx.tp.psum(y), x),
                _blend_cache(ctx.active, nc, cache))

    @staticmethod
    def prefill_chunk(p, x, cache, ctx: BlockCtx):
        y, nc = xlstm.slstm_mixer_chunk(
            p["mixer"], modules.rmsnorm(p["ln"], x, ctx.cfg.norm_eps),
            cache["slstm"], cfg=ctx.cfg, dtype=ctx.dtype, tp=ctx.tp)
        return (_blend(ctx.active, x + ctx.tp.psum(y), x),
                _blend_cache(ctx.active, {"slstm": nc}, cache))


# ----------------------------- enc / dec --------------------------------

def _ln_init(cfg, dtype, device):
    return modules.norm_init(cfg.d_model, bias=True, dtype=dtype,
                             device=device)


class Enc:
    """Whisper encoder layer: bidirectional self-attn + MLP (LayerNorm)."""

    @staticmethod
    def init(gen, cfg, dtype=torch.float32):
        dev = gen.device
        return {"ln1": _ln_init(cfg, dtype, dev),
                "attn": attn_lib.init_attention(gen, cfg, dtype),
                "ln2": _ln_init(cfg, dtype, dev),
                "mlp": _mlp_init(gen, cfg, dtype, gated=False)}

    @staticmethod
    def apply(p, x, ctx: BlockCtx):
        cfg = ctx.cfg
        a = attn_lib.attention(p["attn"],
                               modules.layernorm(p["ln1"], x, cfg.norm_eps),
                               cfg=cfg, positions=ctx.positions, causal=False,
                               tp=ctx.tp, dtype=ctx.dtype)
        x = _blend(ctx.active, x + ctx.tp.psum(a), x)
        mlp = _mlp(p["mlp"], modules.layernorm(p["ln2"], x, cfg.norm_eps), cfg,
                   ctx.dtype)
        x = _blend(ctx.active, x + ctx.tp.psum(mlp), x)
        return x, 0.0

    init_cache = Dense.init_cache  # unused (encoder has no decode), kept uniform

    @staticmethod
    def step(p, x, cache, ctx: BlockCtx):
        raise NotImplementedError("encoder layers have no decode step")


class Dec:
    """Whisper decoder layer: causal self-attn + cross-attn + MLP."""

    @staticmethod
    def init(gen, cfg, dtype=torch.float32):
        dev = gen.device
        return {"ln1": _ln_init(cfg, dtype, dev),
                "attn": attn_lib.init_attention(gen, cfg, dtype),
                "ln_x": _ln_init(cfg, dtype, dev),
                "xattn": attn_lib.init_cross_attention(gen, cfg, dtype),
                "ln2": _ln_init(cfg, dtype, dev),
                "mlp": _mlp_init(gen, cfg, dtype, gated=False)}

    @staticmethod
    def _cross_and_mlp(p, x, ctx: BlockCtx, positions):
        cfg = ctx.cfg
        c = attn_lib.attention(p["xattn"],
                               modules.layernorm(p["ln_x"], x, cfg.norm_eps),
                               cfg=cfg, positions=positions,
                               kv_source=ctx.kv_source, tp=ctx.tp,
                               dtype=ctx.dtype)
        x = _blend(ctx.active, x + ctx.tp.psum(c), x)
        mlp = _mlp(p["mlp"], modules.layernorm(p["ln2"], x, cfg.norm_eps), cfg,
                   ctx.dtype)
        return _blend(ctx.active, x + ctx.tp.psum(mlp), x)

    @staticmethod
    def apply(p, x, ctx: BlockCtx):
        cfg = ctx.cfg
        a = attn_lib.attention(p["attn"],
                               modules.layernorm(p["ln1"], x, cfg.norm_eps),
                               cfg=cfg, positions=ctx.positions, causal=True,
                               tp=ctx.tp, dtype=ctx.dtype)
        x = _blend(ctx.active, x + ctx.tp.psum(a), x)
        return Dec._cross_and_mlp(p, x, ctx, ctx.positions), 0.0

    init_cache = Dense.init_cache

    @staticmethod
    def step(p, x, cache, ctx: BlockCtx):
        cfg = ctx.cfg
        a, nc = attn_lib.decode_attention(
            p["attn"], modules.layernorm(p["ln1"], x, cfg.norm_eps),
            cache["attn"], cfg=cfg, pos=ctx.pos, tp=ctx.tp, dtype=ctx.dtype)
        x = _blend(ctx.active, x + ctx.tp.psum(a), x)
        return (Dec._cross_and_mlp(p, x, ctx, None),
                {"attn": _blend_cache(ctx.active, nc, cache["attn"])})


BLOCKS = {
    "dense": Dense, "moe": Moe, "mamba": Mamba, "hybrid": Hybrid,
    "mlstm": MLstm, "slstm": SLstm, "enc": Enc, "dec": Dec,
}
