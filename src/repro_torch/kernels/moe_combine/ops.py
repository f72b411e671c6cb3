"""Wrappers of the expert layer's combine kernels (``csrc/moe_combine.cu``):
the gather of the experts' output rows back to the routes and the
weighted sum over each token's top-k, as one autograd function.

``moe_combine`` launches ``moe_combine_fwd`` for tensors on a CUDA device
and, in the backward, ``moe_combine_bwd`` (after a memset and
``moe_combine_bwd_owner``, which build the rows' owner map). For tensors
on the CPU and on the meta device it runs the plain version of
``ref.py``. There is no other fallback: a CUDA tensor goes through the
kernels or the call raises.

A route whose slot is the trash row (``slot == rows``: dropped by
capacity, or owned by another tensor shard) adds nothing and is skipped.
The backward relies on what ``models.moe.dispatch`` gives: every other
slot appears once, so each row of the gradient has at most one writer.
Saved for the backward: y (the experts' output, as given), slot and w;
no [T * k, d] tensor.
"""
from __future__ import annotations

import ctypes
import threading

import torch

from repro_torch.kernels import build
from repro_torch.kernels.moe_combine.ref import combine_reference

DTYPES = (torch.bfloat16, torch.float32)
_count_lock = threading.Lock()


def _library():
    lib = build.load("moe_combine")
    vp, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    fwd, bwd = lib.moe_combine_fwd_launch, lib.moe_combine_bwd_launch
    if fwd.argtypes is None:
        fwd.argtypes = [i] + [vp] * 4 + [ll, i, ll, i, vp]
        fwd.restype = ctypes.c_int
    if bwd.argtypes is None:
        bwd.argtypes = [i] + [vp] * 7 + [ll, i, ll, i, vp]
        bwd.restype = ctypes.c_int
    return fwd, bwd


def check(y, slot, w):
    """Raises ValueError unless the kernels take these inputs: y [rows, d]
    bf16 or f32 with d a multiple of 8, slot [T, k] int64, w [T, k] in y's
    dtype, all on one CUDA device."""
    if y.dim() != 2 or slot.dim() != 2 or w.shape != slot.shape:
        raise ValueError(f"moe_combine: y {tuple(y.shape)}, slot "
                         f"{tuple(slot.shape)}, w {tuple(w.shape)}: want "
                         f"[rows, d], [T, k], [T, k]")
    if y.dtype not in DTYPES or w.dtype != y.dtype:
        raise ValueError(f"moe_combine: y is {y.dtype}, w {w.dtype}; the "
                         f"kernels take both bf16 or both f32")
    if slot.dtype != torch.int64:
        raise ValueError(f"moe_combine: slot is {slot.dtype}, not int64")
    if y.shape[1] % 8:
        raise ValueError(f"moe_combine: d = {y.shape[1]} is not a multiple "
                         f"of 8")
    if slot.numel() >= 2 ** 31 or y.shape[0] >= 2 ** 31:
        raise ValueError("moe_combine: 2^31 routes or rows or more")
    for name, t in (("slot", slot), ("w", w)):
        if t.device != y.device:
            raise ValueError(f"moe_combine: {name} is on {t.device}, y on "
                             f"{y.device}")
    if y.device.type != "cuda":
        raise ValueError(f"moe_combine's kernels run on CUDA tensors, not "
                         f"{y.device}")


def _ready(t):
    """t where the kernels can read it in place (contiguous, a 16-byte
    aligned base), else a fresh contiguous copy."""
    if t.is_contiguous() and t.data_ptr() % 16 == 0:
        return t
    return t.clone(memory_format=torch.contiguous_format)


def combine_forward(y, slot, w):
    """[T, d] in y's dtype: each token's sum of ``w * y[slot]`` over its
    routes whose slot is a row of y, in f32, rounded once. One launch of
    ``moe_combine_fwd``, counted in ``combine_forward.launches``."""
    check(y, slot, w)
    y, slot, w = _ready(y), slot.contiguous(), w.contiguous()
    (T, k), (rows, d) = slot.shape, y.shape
    out = torch.empty((T, d), dtype=y.dtype, device=y.device)
    fwd, _ = _library()
    rc = fwd(int(y.dtype == torch.bfloat16), y.data_ptr(), slot.data_ptr(),
             w.data_ptr(), out.data_ptr(), T, k, rows, d,
             torch.cuda.current_stream(y.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"moe_combine_fwd launch failed: CUDA error {rc}")
    with _count_lock:
        combine_forward.launches += 1
    return out


def combine_backward(dout, y, slot, w):
    """(dy [rows, d], dw [T, k], both in y's dtype) for the output gradient
    dout [T, d]: a route's row of dy is ``w * dout[t]``, a row no route
    owns is 0; dw is the dot product of dout[t] and the route's row of y,
    summed in f32 and rounded once, 0 for a route at the trash row. A
    memset and two launches
    (``moe_combine_bwd_owner``, ``moe_combine_bwd``), counted once in
    ``combine_backward.launches``; no atomics, so two calls give the same
    bits."""
    check(y, slot, w)
    if dout.shape != (slot.shape[0], y.shape[1]) or dout.dtype != y.dtype:
        raise ValueError(f"moe_combine: dout is {dout.dtype} "
                         f"{tuple(dout.shape)}, not {y.dtype} "
                         f"{(slot.shape[0], y.shape[1])}")
    y, dout = _ready(y), _ready(dout)
    slot, w = slot.contiguous(), w.contiguous()
    (T, k), (rows, d) = slot.shape, y.shape
    dy = torch.empty_like(y)
    dw = torch.empty((T, k), dtype=y.dtype, device=y.device)
    owner = torch.empty(rows, dtype=torch.int32, device=y.device)
    _, bwd = _library()
    rc = bwd(int(y.dtype == torch.bfloat16), dout.data_ptr(), y.data_ptr(),
             slot.data_ptr(), w.data_ptr(), dy.data_ptr(), dw.data_ptr(),
             owner.data_ptr(), T, k, rows, d,
             torch.cuda.current_stream(y.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"moe_combine_bwd launch failed: CUDA error {rc}")
    with _count_lock:
        combine_backward.launches += 1
    return dy, dw


combine_forward.launches = 0
combine_backward.launches = 0


class _MoeCombine(torch.autograd.Function):
    @staticmethod
    def forward(ctx, y, slot, w):
        ctx.save_for_backward(y, slot, w)
        return combine_forward(y, slot, w)

    @staticmethod
    def backward(ctx, dout):
        y, slot, w = ctx.saved_tensors
        dy, dw = combine_backward(dout, y, slot, w)
        return dy, None, dw


def moe_combine(y, slot, w):
    """y: [rows, d] the experts' output rows; slot: [T, k] each route's
    row, ``rows`` for a route that adds nothing (the trash row); w: [T, k]
    the routes' weights in y's dtype. Returns [T, d], each token's
    weighted sum of its routes' rows. Differentiable in y and w: on CUDA
    through the kernels, elsewhere through ``ref.py``."""
    if y.device.type != "cuda":            # the CPU, or meta (shapes only)
        return combine_reference(y, slot, w)
    return _MoeCombine.apply(y, slot, w)
