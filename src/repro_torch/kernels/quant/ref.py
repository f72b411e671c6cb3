"""Plain PyTorch version of the fused per-channel quantize / dequantize:
the oracle the CUDA kernels of ``csrc/quant.cu`` are held against on the
card (bit for bit), and what the wrappers run for tensors on the CPU.

It follows the JAX package's numpy reference op for op, all in f32:
min and max over rows, ``scale = (hi - lo) * float32(1/levels)`` (a
multiply by the reciprocal, not a divide), an IEEE divide, ``rint``
rounding half to even (``torch.round`` does), and ``lo + scale*q`` as two
separately rounded operations (no FMA), in the residual and in the
dequantize alike — so the error-feedback invariant
``res' == z - dequantize(q, lo, scale)`` holds exactly.

Conventions: channel = last axis; a degenerate channel (``hi == lo``, or
a non-finite range) stores ``scale = 0`` and ``q = 0`` and decodes to
exactly ``lo``; non-finite inputs are the caller's fallback case (``ok``
is False, and the caller ships ``z`` exactly).
"""
from __future__ import annotations

import numpy as np
import torch


def inv_levels(levels: int) -> float:
    """``float32(1/levels)`` as the kernels take it: the f32 nearest to the
    double ``1/levels``, as numpy rounds it."""
    return float(np.float32(1.0 / levels))


def quantize_ef_reference(x, res=None, *, levels: int = 255):
    """``x``: f32 tensor [..., C]; ``res``: carried residual of the same
    shape, or None (zeros). Returns ``(q u8 [..., C], lo f32 [C],
    scale f32 [C], res' f32 [..., C], ok 0-d bool, z f32 [..., C])`` with
    ``z = x + res`` (``x`` itself when ``res`` is None)."""
    z = x if res is None else x + res
    C = z.shape[-1]
    z2 = z.reshape(-1, C)
    lo = z2.amin(dim=0)
    hi = z2.amax(dim=0)
    inv = torch.tensor(inv_levels(levels), dtype=torch.float32,
                       device=z.device)
    scale = (hi - lo) * inv
    zero = torch.zeros((), dtype=torch.float32, device=z.device)
    scale = torch.where(torch.isfinite(scale) & (scale > 0), scale, zero)
    safe = torch.where(scale > 0, scale, torch.ones_like(scale))
    q = torch.clamp(torch.round((z2 - lo) / safe), 0, levels)
    q = torch.where(scale > 0, q, zero)
    dq = lo + scale * q
    res2 = z2 - dq
    ok = torch.isfinite(z).all()
    return (q.to(torch.uint8).reshape(z.shape), lo, scale,
            res2.reshape(z.shape), ok, z)


def dequantize_reference(q, lo, scale):
    """``q``: u8 [..., C]; ``lo``/``scale``: f32 [C] -> f32 [..., C],
    ``lo + scale*q`` rounded once per operation."""
    return lo + scale * q.to(torch.float32)
