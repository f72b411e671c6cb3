"""Mamba2 (SSD) mixer: chunked state-space recurrence.

The port of ``repro.models.mamba2``. Math (per head h, state size N, head
dim P):
    a_t = exp(dt_t * A_h)            (scalar decay, A_h < 0)
    h_t = a_t * h_{t-1} + dt_t * x_t B_t^T        (h: [P, N])
    y_t = h_t C_t + D_h x_t

The full-sequence mixer and the chunked-prefill mixer run the chunked SSD
scan through ``kernels.ssm_scan.ssd_scan``, the SSD scan kernel (K5) on
the card and its plain version on the CPU (``ssd_chunked``, which the
JAX package keeps here, lives beside the kernel in
``kernels/ssm_scan/ref.py``). Decode uses the O(1) step form in plain
PyTorch, as the JAX package does.

The chunk length: the JAX mixer halves its chunk from 128 until it
divides the sequence (``mamba2.py:155-158``), so S=1000 runs 125 chunks of
8. On the CPU the port does the same, so its parity with the JAX package
is like for like. On CUDA, K5 always runs chunks of 128 and masks the
ragged tail (exact: dt = 0 there). The scan's result does not depend on
the chunk length but for rounding: the two agree within 1e-4
(``tests/test_kernels.py:78-91``).

Tensor parallelism: unsupported inside the mixer (zamba2 runs tp=1).
Single group (B, C shared across heads).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.ssm_scan import ssd_scan
from repro_torch.models import modules

MAMBA_HEAD_DIM = 64
DEFAULT_CHUNK = 128
f32 = torch.float32


def dims(cfg: ModelConfig):
    d_inner = cfg.ssm_expand * cfg.d_model
    nheads = d_inner // MAMBA_HEAD_DIM
    return d_inner, nheads, cfg.ssm_state


def init_mamba2(gen: torch.Generator, cfg: ModelConfig, dtype=f32):
    d = cfg.d_model
    d_inner, H, N = dims(cfg)
    conv_dim = d_inner + 2 * N
    dev = gen.device
    # in_proj emits [z | x | B | C | dt]
    in_dim = 2 * d_inner + 2 * N + H
    u = modules.rand(gen, (H,), dtype)
    lo, hi = math.log(0.001), math.log(0.1)
    return {
        "in_proj": modules.dense_init(gen, d, in_dim, dtype=dtype),
        "conv_w": modules.randn(gen, (cfg.ssm_conv_width, conv_dim), dtype)
                  * (1.0 / cfg.ssm_conv_width),
        "conv_b": torch.zeros((conv_dim,), dtype=dtype, device=dev),
        "A_log": torch.log(torch.linspace(1.0, 16.0, H, dtype=dtype,
                                          device=dev)),
        "D": torch.ones((H,), dtype=dtype, device=dev),
        "dt_bias": torch.log(torch.expm1(torch.exp(u * (hi - lo) + lo))),
        "norm": modules.norm_init(d_inner, dtype=dtype, device=dev),
        "out_proj": modules.dense_init(gen, d_inner, d, dtype=dtype),
    }


def _split_proj(cfg, proj):
    d_inner, H, N = dims(cfg)
    return torch.split(proj, [d_inner, d_inner, N, N, H], dim=-1)


def _causal_conv(x, w, b):
    """Depthwise causal conv. x: [B, S, C]; w: [K, C]."""
    K = w.shape[0]
    pad = F.pad(x, (0, 0, K - 1, 0))
    out = sum(pad[:, i:i + x.shape[1], :] * w[i] for i in range(K))
    return out + b


def ssd_step(h, xt, dt, A, Bt, Ct, D):
    """One decode step. h: [B,H,P,N]; xt: [B,H,P]; dt: [B,H]; Bt,Ct: [B,N]."""
    a = torch.exp(dt * A)                                  # [B,H]
    h_new = (a[:, :, None, None] * h
             + dt[:, :, None, None] * xt[:, :, :, None]
             * Bt[:, None, None, :])
    y = torch.einsum("bhpn,bn->bhp", h_new, Ct) + xt * D[None, :, None]
    return y, h_new


def _chunk(L: int, device, chunk: int = DEFAULT_CHUNK) -> int:
    """The scan's chunk length: K5's on CUDA, and on meta, which stands
    for the card in a FLOP count (``launch/dryrun.py``); the JAX mixer's
    on the CPU (halved until it divides L)."""
    if device.type in ("cuda", "meta"):
        return chunk
    ck = min(chunk, L)
    while L % ck:
        ck //= 2
    return max(ck, 1)


def _ssm_inputs(p, cfg, conv_out, dt):
    """(xh, dt, A, Bm, Cm, D) in f32 for the scan, from the conv output
    and the raw dt of the projection."""
    d_inner, H, N = dims(cfg)
    xi, Bm, Cm = torch.split(conv_out, [d_inner, N, N], dim=-1)
    dt = F.softplus(dt.to(f32) + p["dt_bias"])
    A = -torch.exp(p["A_log"].to(f32))
    xh = xi.reshape(*xi.shape[:2], H, MAMBA_HEAD_DIM).to(f32)
    return xh, dt, A, Bm.to(f32), Cm.to(f32), p["D"].to(f32)


def _gate_out(p, y, z, dtype):
    y = y.reshape(*y.shape[:2], -1).to(dtype)
    y = modules.rmsnorm(p["norm"], y * F.silu(z))
    return modules.dense(p["out_proj"], y, dtype)


def mamba2_mixer(p, x, *, cfg: ModelConfig, dtype=torch.bfloat16,
                 chunk: int = DEFAULT_CHUNK):
    """Full-sequence mixer. x: [B, S, d] -> [B, S, d]."""
    proj = modules.dense(p["in_proj"], x, dtype)
    z, xi, Bm, Cm, dt = _split_proj(cfg, proj)
    conv_in = torch.cat([xi, Bm, Cm], dim=-1)
    conv_out = F.silu(_causal_conv(conv_in, p["conv_w"].to(dtype),
                                   p["conv_b"].to(dtype)))
    y = ssd_scan(*_ssm_inputs(p, cfg, conv_out, dt),
                 chunk=_chunk(x.shape[1], x.device, chunk))
    return _gate_out(p, y, z, dtype)


def mamba2_mixer_chunk(p, x, cache, *, cfg: ModelConfig,
                       dtype=torch.bfloat16, chunk: int = DEFAULT_CHUNK):
    """Chunked-prefill mixer: process L tokens continuing from ``cache``
    (conv tail + SSM state). Returns (y [B, L, d], new_cache)."""
    proj = modules.dense(p["in_proj"], x, dtype)
    z, xi, Bm, Cm, dt = _split_proj(cfg, proj)
    conv_in = torch.cat([xi, Bm, Cm], dim=-1)
    hist = torch.cat([cache["conv"].to(dtype), conv_in], dim=1)
    w = p["conv_w"].to(dtype)
    K = w.shape[0]
    L = conv_in.shape[1]
    # causal conv with carried history: window ending at each new token
    conv_out = F.silu(sum(hist[:, i:i + L, :] * w[i] for i in range(K))
                      + p["conv_b"].to(dtype))
    y, h_final = ssd_scan(*_ssm_inputs(p, cfg, conv_out, dt),
                          chunk=_chunk(L, x.device, chunk),
                          h0=cache["ssm"])
    out = _gate_out(p, y, z, dtype)
    new_cache = {"conv": hist[:, -(K - 1):, :].to(cache["conv"].dtype),
                 "ssm": h_final}
    return out, new_cache


def init_mamba2_cache(cfg: ModelConfig, batch: int, dtype=f32,
                      device="cpu"):
    d_inner, H, N = dims(cfg)
    conv_dim = d_inner + 2 * N
    return {
        "conv": torch.zeros((batch, cfg.ssm_conv_width - 1, conv_dim),
                            dtype=dtype, device=device),
        "ssm": torch.zeros((batch, H, MAMBA_HEAD_DIM, N), dtype=f32,
                           device=device),
    }


def mamba2_step(p, x, cache, *, cfg: ModelConfig, dtype=torch.bfloat16):
    """One-token decode. x: [B, 1, d]."""
    proj = modules.dense(p["in_proj"], x, dtype)
    z, xi, Bm, Cm, dt = _split_proj(cfg, proj)
    conv_in = torch.cat([xi, Bm, Cm], dim=-1)              # [B,1,conv_dim]
    hist = torch.cat([cache["conv"].to(dtype), conv_in], dim=1)
    w = p["conv_w"].to(dtype)
    K = w.shape[0]
    conv_out = F.silu(torch.sum(hist[:, -K:, :] * w, dim=1, keepdim=True)
                      + p["conv_b"].to(dtype))
    xh, dt, A, Bm, Cm, D = _ssm_inputs(p, cfg, conv_out, dt)
    y, h_new = ssd_step(cache["ssm"], xh[:, 0], dt[:, 0], A, Bm[:, 0],
                        Cm[:, 0], D)
    out = _gate_out(p, y[:, None], z, dtype)
    new_cache = {"conv": hist[:, 1:, :].to(cache["conv"].dtype),
                 "ssm": h_new}
    return out, new_cache
