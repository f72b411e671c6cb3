"""Wrappers of the fused quantize (K2) and dequantize (K3) kernels: the
on-device side of the ``int8-fused`` wire tier (``runtime/codec.py`` tag
13), called by ``runtime/stage_executor.StageExecutor`` at the stage
boundary.

A tensor of any rank is viewed as ``[rows, C]`` with channel = last axis.
``quantize_ef`` / ``dequantize`` launch the CUDA kernels of
``csrc/quant.cu`` for tensors on a CUDA device, and run the plain version
of ``ref.py`` for tensors on the CPU. There is no other fallback: a CUDA
tensor goes through the kernel or the call raises.
"""
from __future__ import annotations

import ctypes
import threading

import torch

from repro_torch.kernels import build
from repro_torch.kernels.quant.ref import (dequantize_reference, inv_levels,
                                           quantize_ef_reference)

_count_lock = threading.Lock()     # worker threads launch concurrently


def _library():
    lib = build.load("quant")
    q, dq = lib.quantize_ef_launch, lib.dequantize_launch
    if q.argtypes is None:
        vp = ctypes.c_void_p
        q.argtypes = [vp, vp, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                      ctypes.c_float] + [vp] * 7 + [vp]
        q.restype = ctypes.c_int
        dq.argtypes = [vp, vp, vp, ctypes.c_longlong, ctypes.c_int, vp, vp]
        dq.restype = ctypes.c_int
    return q, dq


def _check(name, t, dtype, shape=None, device=None):
    if not torch.is_tensor(t):
        raise TypeError(f"{name} must be a tensor, got {type(t).__name__}")
    if t.dtype != dtype:
        raise ValueError(f"{name} must be {dtype}, got {t.dtype}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} is {tuple(t.shape)}, want {tuple(shape)}")
    if device is not None and t.device != device:
        raise ValueError(f"{name} is on {t.device}, want {device}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _device_of(t) -> torch.device:
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"the quant kernels run on CUDA or CPU tensors, "
                         f"not {t.device}")
    return t.device


def quantize_ef(x, res=None, *, levels: int = 255, with_z: bool = True):
    """Fused per-channel affine quantize with error feedback.

    ``x``: f32 [..., C] (channel = last axis); ``res``: carried residual
    of the same shape, or None (zeros — the first send).

    Returns ``(q, lo, scale, res', ok, z)``: ``q`` u8 [..., C] codes in
    ``[0, levels]``; ``lo``/``scale`` f32 [C] (scale 0 = degenerate
    channel, decoded exactly as ``lo``); ``res'`` f32 [..., C] the next
    residual ``z - dequantize(q)``; ``ok`` a 0-d bool tensor on the
    device, False when ``z`` has non-finite values (ship ``z`` exactly
    then, and reset the residual); ``z`` = ``x + res`` (``x`` itself when
    ``res`` is None), or None with ``with_z=False``, where the kernel
    does not write it (the live runtime forms ``x + res`` itself in the
    rare non-finite case). Counts each launch in
    ``quantize_ef.launches``."""
    _check("x", x, torch.float32)
    if x.dim() < 1 or x.numel() == 0:
        raise ValueError(f"quantize_ef needs a non-empty tensor, got shape "
                         f"{tuple(x.shape)}")
    if not 1 <= levels <= 255:
        raise ValueError(f"levels must be in [1, 255] (u8 codes), got "
                         f"{levels}")
    device = _device_of(x)
    if res is not None:
        _check("res", res, torch.float32, x.shape, device)
    if device.type == "cpu":
        out = quantize_ef_reference(x, res, levels=levels)
        return out if with_z else out[:5] + (None,)
    C = x.shape[-1]
    rows = x.numel() // C
    q = torch.empty(x.shape, dtype=torch.uint8, device=device)
    lo = torch.empty(C, dtype=torch.float32, device=device)
    scale = torch.empty(C, dtype=torch.float32, device=device)
    res2 = torch.empty_like(x)
    z_out = torch.empty_like(x) if with_z and res is not None else None
    ok = torch.empty((), dtype=torch.bool, device=device)
    scratch = torch.empty(2 * C + 1, dtype=torch.int32, device=device)
    launch, _ = _library()
    stream = torch.cuda.current_stream(device).cuda_stream
    rc = launch(x.data_ptr(), None if res is None else res.data_ptr(), rows,
                C, levels, inv_levels(levels), q.data_ptr(), lo.data_ptr(),
                scale.data_ptr(), res2.data_ptr(),
                None if z_out is None else z_out.data_ptr(), ok.data_ptr(),
                scratch.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"quantize_ef kernel launch failed: CUDA error "
                           f"{rc}")
    with _count_lock:
        quantize_ef.launches += 1
    z = (x if res is None else z_out) if with_z else None
    return q, lo, scale, res2, ok, z


quantize_ef.launches = 0


def dequantize(q, lo, scale):
    """Fused dequantize: u8 codes [..., C] + per-channel f32 ``lo`` and
    ``scale`` [C] -> f32 [..., C], ``lo + scale*q`` (the exact expression
    of ``quantize_ef``'s residual). Counts each launch in
    ``dequantize.launches``."""
    _check("q", q, torch.uint8)
    if q.dim() < 1 or q.numel() == 0:
        raise ValueError(f"dequantize needs non-empty codes, got shape "
                         f"{tuple(q.shape)}")
    device = _device_of(q)
    C = q.shape[-1]
    _check("lo", lo, torch.float32, (C,), device)
    _check("scale", scale, torch.float32, (C,), device)
    if device.type == "cpu":
        return dequantize_reference(q, lo, scale)
    out = torch.empty(q.shape, dtype=torch.float32, device=device)
    _, launch = _library()
    stream = torch.cuda.current_stream(device).cuda_stream
    rc = launch(q.data_ptr(), lo.data_ptr(), scale.data_ptr(), q.numel(), C,
                out.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"dequantize kernel launch failed: CUDA error "
                           f"{rc}")
    with _count_lock:
        dequantize.launches += 1
    return out


dequantize.launches = 0
