"""Wrappers of the fused quantize (K2) and dequantize (K3) kernels: the
on-device side of the ``int8-fused`` wire tier (``runtime/codec.py`` tag
13), called by ``runtime/stage_executor.StageExecutor`` at the stage
boundary.

A tensor of any rank is viewed as ``[rows, C]`` with channel = last axis.
``quantize_ef`` / ``dequantize`` launch the CUDA kernels of
``csrc/quant.cu`` for tensors on a CUDA device, and run the plain version
of ``ref.py`` for tensors on the CPU. There is no other fallback: a CUDA
tensor goes through the kernel or the call raises (also when the
cooperative launch of K2 cannot place its grid).

``quantize_plan`` and ``dequantize_plan`` say what each launch is given,
from the sizes and the 16-byte phase of the pointers alone: the grid, the
share of a block, whether K2 keeps z on chip across its grid barrier (or
reads x and res again after it), and for each pointer its head (elements
before the first whole 16-byte unit), its tail (elements after the last)
and the width it is read or written in. The outputs are placed at the
phase of x (K2) or of the codes (K3), so that both sides of a unit are
aligned together.
"""
from __future__ import annotations

import ctypes
import functools
import math
import threading
from typing import NamedTuple

import torch

from repro_torch.kernels import build
from repro_torch.kernels.quant.ref import (dequantize_reference, inv_levels,
                                           quantize_ef_reference)

SMS = 132                    # streaming multiprocessors of an H100 SXM
K2_THREADS = 1024            # a K2 block; one block an SM
K3_THREADS = 256
KEYS_MAX = 8192              # channels whose keys K2 keeps in shared memory
FOLD_MAX = 8192              # K2 blocks * C: the partial keys a block folds
SMEM_MAX = 231424            # dynamic shared memory a block may take
K3_BLOCKS_PER_SM = 3         # resident at once (K3's launch bounds)
_count_lock = threading.Lock()     # worker threads launch concurrently


def _library():
    lib = build.load("quant")
    q, dq = lib.quantize_ef_launch, lib.dequantize_launch
    if q.argtypes is None:
        vp, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        q.argtypes = ([vp, vp, ll, i, i, ctypes.c_float] + [vp] * 7
                      + [i, ll, i, i, i, i, vp])
        q.restype = i
        dq.argtypes = [vp, vp, vp, ll, i, vp, i, ll, i, vp]
        dq.restype = i
    return q, dq


def _round16(n: int) -> int:
    return -(-n // 16) * 16


def _phase(t, name: str) -> int:
    """Elements of 4 bytes ``t`` starts past a 16-byte boundary."""
    ptr = t.data_ptr()
    if ptr % 4:
        raise ValueError(f"{name} must be 4-byte aligned")
    return ptr % 16 // 4


class QuantizePlan(NamedTuple):
    grid: int               # blocks, all resident (one an SM)
    per_block: int          # periods a block takes
    period_units: int       # 16-byte units in a period of lcm(C, 4)
    units: int              # whole units of x after its head
    head: int               # elements of x before its first unit
    tail: int               # elements of x after its last unit
    z_on_chip: bool         # z kept in shared memory across the barrier
    keys_on_chip: bool      # per-channel keys in shared memory
    smem: int               # dynamic shared memory of a block, bytes
    pointers: dict          # name -> (head, tail, bytes a thread moves)
    out_phase: int          # elements q and res' (and z) start past 16 B


class DequantizePlan(NamedTuple):
    grid: int
    per_block: int
    period_units: int       # 16-code units in a period of lcm(C, 16)
    units: int              # whole units of codes after their head
    head: int
    tail: int
    pointers: dict
    out_phase: int          # elements the output starts past 16 bytes


@functools.lru_cache(maxsize=1024)
def _quantize_plan(n, C, x_phase, res_phase, with_z, sms):
    head = min((4 - x_phase) % 4, n)
    units, tail = divmod(n - head, 4)
    J = C // math.gcd(C, 4)
    rows_at_once = K2_THREADS // min(J, K2_THREADS)
    periods = -(-units // J)
    keys_on_chip = C <= KEYS_MAX
    grid = 1
    if periods and keys_on_chip:
        grid = max(1, min(sms, -(-periods // rows_at_once), FOLD_MAX // C))
    per_block = -(-periods // grid)
    if per_block:
        grid = -(-periods // per_block)        # no block without work
    keys = _round16(8 * C) if keys_on_chip else 0
    z_on_chip = keys + per_block * J * 16 <= SMEM_MAX
    smem = keys + (per_block * J * 16 if z_on_chip else 0)
    ends = (head, tail)
    pointers = {"x": (*ends, 16), "q": (*ends, 4), "res_out": (*ends, 16)}
    if res_phase is not None:
        pointers["res"] = (*ends, 16 if res_phase == x_phase else 4)
        if with_z:
            pointers["z_out"] = (*ends, 16)
    return QuantizePlan(grid, per_block, J, units, head, tail, z_on_chip,
                        keys_on_chip, smem, pointers, x_phase)


@functools.lru_cache(maxsize=1024)
def _dequantize_plan(n, C, q_phase, sms):
    head = min((16 - q_phase) % 16, n)
    units, tail = divmod(n - head, 16)
    J = C // math.gcd(C, 16)
    rows_at_once = K3_THREADS // min(J, K3_THREADS)
    periods = -(-units // J)
    grid = max(1, min(-(-periods // rows_at_once), K3_BLOCKS_PER_SM * sms))
    per_block = -(-periods // grid)
    if per_block:
        grid = -(-periods // per_block)
    pointers = {"q": (head, tail, 16), "out": (head, tail, 16)}
    return DequantizePlan(grid, per_block, J, units, head, tail, pointers,
                          -head % 4)


def quantize_plan(x, res=None, *, with_z: bool = False,
                  sms: int = SMS) -> QuantizePlan:
    """K2's launch for ``x`` (and ``res``), from sizes and phases alone.

    The flat index is cut into periods of lcm(C, 4) elements; a 16-byte
    unit of a period always holds the same four channels, so a thread
    keeps one unit column and walks periods. A block takes
    ``K2_THREADS // period_units`` periods at once (at least one such row
    of periods a block), the grid is at most one block an SM (so the
    cooperative launch can place it) and ``FOLD_MAX // C`` blocks (each
    block folds every block's partial keys after the barrier). z stays
    on chip where a block's share and its keys fit in ``SMEM_MAX``; else
    the kernel reads x and res again after the barrier. Above
    ``KEYS_MAX`` channels the keys live in device memory and one block
    does the work. res is read 16 bytes at a time where it has x's phase,
    4 bytes at a time otherwise; q, res' and z are placed at x's phase."""
    res_phase = None if res is None else _phase(res, "res")
    return _quantize_plan(x.numel(), x.shape[-1], _phase(x, "x"), res_phase,
                          bool(with_z), sms)


def dequantize_plan(q, *, sms: int = SMS) -> DequantizePlan:
    """K3's launch for codes ``q``: 16 codes a thread and unit, periods of
    lcm(C, 16) codes, one unit column a thread; the head runs to the
    codes' first 16-byte boundary (the code view ``StageExecutor`` makes
    at byte offset 8C has a head of 8 for odd C); the output is placed so
    that its units are 16-byte aligned too."""
    return _dequantize_plan(q.numel(), q.shape[-1], q.data_ptr() % 16, sms)


@functools.lru_cache(maxsize=16)
def _sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _at_phase(shape, dtype, phase: int, device):
    """An empty contiguous tensor whose data starts ``phase`` elements
    past a 16-byte boundary (the allocator's blocks start on one)."""
    if phase == 0:
        return torch.empty(shape, dtype=dtype, device=device)
    n = math.prod(shape)
    return torch.empty(n + phase, dtype=dtype,
                       device=device)[phase:].view(shape)


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
    want_z = with_z and res is not None
    plan = quantize_plan(x, res, with_z=want_z, sms=_sms(device.index))
    q = _at_phase(x.shape, torch.uint8, plan.out_phase, device)
    res2 = _at_phase(x.shape, torch.float32, plan.out_phase, device)
    z_out = (_at_phase(x.shape, torch.float32, plan.out_phase, device)
             if want_z else None)
    # lo | scale | the blocks' partial keys and flags (as f32 bits)
    params = torch.empty(2 * C + plan.grid * (2 * C + 1),
                         dtype=torch.float32, device=device)
    lo, scale, _ = params.split([C, C, plan.grid * (2 * C + 1)])
    ok = torch.empty((), dtype=torch.bool, device=device)
    launch, _ = _library()
    rc = launch(x.data_ptr(), None if res is None else res.data_ptr(),
                x.numel(), C, levels, inv_levels(levels), q.data_ptr(),
                lo.data_ptr(), scale.data_ptr(), res2.data_ptr(),
                None if z_out is None else z_out.data_ptr(), ok.data_ptr(),
                params.data_ptr() + 8 * C, plan.grid, plan.per_block,
                plan.head, plan.pointers.get("res", (0, 0, 16))[2] == 16,
                plan.z_on_chip, plan.smem,
                torch.cuda.current_stream(device).cuda_stream)
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
    plan = dequantize_plan(q, sms=_sms(device.index))
    out = _at_phase(q.shape, torch.float32, plan.out_phase, device)
    _, launch = _library()
    rc = launch(q.data_ptr(), lo.data_ptr(), scale.data_ptr(), q.numel(), C,
                out.data_ptr(), plan.grid, plan.per_block, plan.head,
                torch.cuda.current_stream(device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"dequantize kernel launch failed: CUDA error "
                           f"{rc}")
    with _count_lock:
        dequantize.launches += 1
    return out


dequantize.launches = 0
