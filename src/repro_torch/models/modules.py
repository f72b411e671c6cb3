"""Module primitives of the transformer stacks, in PyTorch.

The port of ``repro.models.modules``. Params are plain pytrees (dicts of
tensors). Every primitive is a pair of ``*_init(generator, ...) ->
params`` and a pure apply function with the JAX package's layouts (dense
weights ``[in, out]``, activations ``[..., seq, heads, head_dim]``). The
inits draw from an explicit ``torch.Generator`` on the device the params
live on; they cannot reproduce ``jax.random``, so parity tests carry the
JAX package's weights across (``models/model.params_from_numpy``). The
meta device has no generator: there the inits take ``ShapeOnly`` and
build params of the right shapes and dtypes that hold no values.
"""
from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch import tree


def dtype_of(name: str) -> torch.dtype:
    return {"bfloat16": torch.bfloat16, "float32": torch.float32,
            "float16": torch.float16}[name]


# ---------------------------------------------------------------- init --

class ShapeOnly:
    """Takes a generator's place on the meta device: ``randn`` and
    ``rand`` give empty meta tensors for it, so an init builds its param
    tree without a draw and without memory (``launch/specs.params_sds``)."""
    device = torch.device("meta")


def randn(gen, shape, dtype=torch.float32):
    """Standard normal draws from ``gen`` on its device (none on meta)."""
    if isinstance(gen, ShapeOnly):
        return torch.empty(shape, dtype=dtype, device=gen.device)
    return torch.randn(shape, generator=gen, dtype=dtype, device=gen.device)


def rand(gen, shape, dtype=torch.float32):
    """Uniform [0, 1) draws from ``gen`` on its device (none on meta)."""
    if isinstance(gen, ShapeOnly):
        return torch.empty(shape, dtype=dtype, device=gen.device)
    return torch.rand(shape, generator=gen, dtype=dtype, device=gen.device)


def dense_init(gen: torch.Generator, in_dim: int, out_dim: int, *,
               bias: bool = False, scale: float | None = None,
               dtype=torch.float32):
    scale = float(1.0 / np.sqrt(in_dim)) if scale is None else scale
    p = {"w": randn(gen, (in_dim, out_dim), dtype) * scale}
    if bias:
        p["b"] = torch.zeros((out_dim,), dtype=dtype, device=gen.device)
    return p


def norm_init(dim: int, *, bias: bool = False, dtype=torch.float32,
              device="cpu"):
    p = {"scale": torch.ones((dim,), dtype=dtype, device=device)}
    if bias:
        p["bias"] = torch.zeros((dim,), dtype=dtype, device=device)
    return p


def embed_init(gen: torch.Generator, vocab: int, dim: int,
               dtype=torch.float32):
    return {"table": randn(gen, (vocab, dim), dtype) * 0.02}


# --------------------------------------------------------------- apply --

def dense(p, x, dtype=None):
    """``x @ w (+ b)``; with ``dtype``, ``w`` and ``x`` are cast to it at
    every call, as the JAX package does (its params stay f32)."""
    w = p["w"]
    if dtype is not None:
        w = w.to(dtype)
        x = x.to(dtype)
    y = x @ w
    if "b" in p:
        y = y + p["b"].to(y.dtype)
    return y


def rmsnorm(p, x, eps: float = 1e-5):
    xf = x.to(torch.float32)
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    y = y * p["scale"].to(torch.float32)
    if "bias" in p:
        y = y + p["bias"].to(torch.float32)
    return y.to(x.dtype)


def layernorm(p, x, eps: float = 1e-5):
    xf = x.to(torch.float32)
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.var(xf, dim=-1, keepdim=True, unbiased=False)
    y = (xf - mu) * torch.rsqrt(var + eps) * p["scale"].to(torch.float32)
    if "bias" in p:
        y = y + p["bias"].to(torch.float32)
    return y.to(x.dtype)


def activation(name: str):
    return {
        "silu": F.silu,
        "gelu": lambda x: F.gelu(x, approximate="tanh"),
        "relu": F.relu,
        "relu6": F.relu6,
    }[name]


# ---------------------------------------------------------------- rope --

def rope_freqs(head_dim: int, theta: float, fraction: float = 1.0):
    """Inverse frequencies (f32, computed with numpy as the JAX package
    does) for the rotated sub-dimension, and its width."""
    rot = int(head_dim * fraction)
    rot -= rot % 2
    inv = 1.0 / (theta ** (np.arange(0, rot, 2, dtype=np.float32) / rot))
    return torch.from_numpy(np.asarray(inv, np.float32)), rot


@functools.lru_cache(maxsize=None)
def _inv_freqs_on(head_dim: int, theta: float, fraction: float, device):
    """``rope_freqs`` on ``device``, copied there once: a host-to-device
    copy at every call would make the host wait for the card."""
    inv, rot = rope_freqs(head_dim, theta, fraction)
    return inv.to(device), rot


def apply_rope(x, positions, theta: float, fraction: float = 1.0):
    """x: [..., seq, heads, head_dim]; positions: [..., seq].

    ``fraction < 1`` rotates only the first ``fraction`` of head dims
    (chatglm3's "2d RoPE": half rotary, half pass-through).
    """
    if theta <= 0.0:
        return x
    inv, rot = _inv_freqs_on(x.shape[-1], theta, fraction, x.device)
    if rot == 0:
        return x
    ang = positions[..., :, None].to(torch.float32) * inv  # [..., seq, rot/2]
    cos = torch.cos(ang)[..., :, None, :]
    sin = torch.sin(ang)[..., :, None, :]
    xr = x[..., :rot].to(torch.float32)
    x1, x2 = xr[..., 0::2], xr[..., 1::2]
    r1 = x1 * cos - x2 * sin
    r2 = x2 * cos + x1 * sin
    rotated = torch.stack([r1, r2], dim=-1).reshape(xr.shape)
    return torch.cat([rotated.to(x.dtype), x[..., rot:]], dim=-1)


def sinusoidal_positions(max_len: int, dim: int, device="cpu"):
    """Whisper-style sinusoidal position embedding table [max_len, dim]."""
    pos = np.arange(max_len)[:, None]
    i = np.arange(dim // 2)[None, :]
    ang = pos / (10_000 ** (2 * i / dim))
    table = np.concatenate([np.sin(ang), np.cos(ang)], axis=-1)
    return torch.as_tensor(table.astype(np.float32), device=device)


# -------------------------------------------------------------- counts --

def count_params(params) -> int:
    """The number of parameters in a params tree (on any device, meta
    too): the sum of its leaves' element counts."""
    return sum(int(np.prod(leaf.shape)) for leaf in tree.leaves(params))
