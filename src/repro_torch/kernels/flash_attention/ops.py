"""Wrappers of the flash attention kernel (K4): the counterpart of
``repro.kernels.flash_attention.kernel.flash_attention_kernel`` (with a
``q_offset``, for chunked prefill) and of
``repro.kernels.flash_attention.ops.flash_attention`` (an autograd
function whose backward recomputes the plain version, as the JAX package's
custom VJP does with ``jax.vjp``).

``flash_attention_kernel`` launches a CUDA kernel for tensors on a CUDA
device, and runs the plain version of ``ref.py`` for tensors on the CPU.
Two kernels, chosen by dtype alone (``launch_plan``):

- route 1, bf16 q over bf16 k and v (the serving path's dtype):
  ``csrc/flash_attention_sm90.cu``, wgmma on the tensor cores fed by TMA;
- route 2, f32 q, and bf16 q over an f32 kv cache:
  ``csrc/flash_attention.cu``, f32 on the CUDA cores.

Each pair has exactly one kernel and there is no other fallback: a CUDA
tensor goes through its route's kernel or the call raises. Nothing is
padded: both kernels mask the true sequence edges.
"""
from __future__ import annotations

import ctypes
import threading

import torch

from repro_torch.kernels import build
from repro_torch.kernels.flash_attention.ref import attention_reference

HEAD_DIMS = (32, 64, 112, 128)      # 112: zamba2-7b's hybrid attention
DTYPES = (torch.float32, torch.bfloat16)
_count_lock = threading.Lock()


def _library(route: int):
    vp, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    if route == 1:
        fn = build.load("flash_attention_sm90").flash_attention_sm90_launch
        types = [vp] * 4 + [i] * 6 + [ll] * 9 + [i, i, i, ctypes.c_float, vp]
    else:
        fn = build.load("flash_attention").flash_attention_launch
        types = [vp] * 4 + [i] * 8 + [ll] * 9 + [i, i, i, ctypes.c_float, vp]
    if fn.argtypes is None:
        fn.argtypes, fn.restype = types, ctypes.c_int
    return fn


def _tma_ready(t) -> bool:
    """What route 1's TMA tensor maps need of a [B, heads, seq, dh] view:
    a contiguous last axis, a 16-byte aligned base, and the other strides
    multiples of 16 bytes (a stride over a dimension of size 1 is never
    used)."""
    return (t.stride(-1) == 1 and t.data_ptr() % 16 == 0
            and all(n == 1 or st * t.element_size() % 16 == 0
                    for n, st in zip(t.shape[:-1], t.stride()[:-1])))


def launch_plan(q, k, v):
    """(route, which of q, k, v to copy first), from the dtypes, shapes,
    strides and base alignment alone. Route 1 for bf16 q over bf16 k and
    v, route 2 otherwise. Route 2 needs only a contiguous last axis; route
    1 also what TMA needs (``_tma_ready``). A view the model passes
    (``[B, S, H, dh].transpose(1, 2)``, or such a view over a slice of the
    KV cache) needs no copy."""
    bf = torch.bfloat16
    route = 1 if q.dtype == k.dtype == v.dtype == bf else 2
    ready = _tma_ready if route == 1 else (lambda t: t.stride(-1) == 1)
    return route, tuple(not ready(t) for t in (q, k, v))


def prepare(q, k, v):
    """(route, q, k, v): the route of ``launch_plan``, and each tensor that
    route's kernel cannot read in place replaced by a fresh contiguous copy
    (a clone: ``.contiguous()`` would keep a contiguous tensor's
    misaligned base)."""
    route, copy = launch_plan(q, k, v)
    return (route, *(t.clone(memory_format=torch.contiguous_format) if c
                     else t for t, c in zip((q, k, v), copy)))


def _strides(t):
    """t's (batch, head, position) strides, with the stride of a dimension
    of size 1 replaced by one TMA accepts (it is never multiplied)."""
    outer = max(st * n for n, st in zip(t.shape, t.stride()) if n > 1)
    return [st if n > 1 else outer
            for n, st in zip(t.shape[:3], t.stride()[:3])]


def _check(q, k, v):
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not torch.is_tensor(t) or t.dim() != 4:
            raise ValueError(f"flash_attention: {name} must be a 4-D tensor "
                             f"[B, heads, seq, head_dim]")
        if t.dtype not in DTYPES:
            raise ValueError(f"flash_attention: {name} is {t.dtype}, not "
                             f"f32 or bf16")
        if t.device != q.device:
            raise ValueError(f"flash_attention: {name} is on {t.device}, q "
                             f"on {q.device}")
    B, H, _, dh = q.shape
    if k.shape != v.shape or k.shape[0] != B or k.shape[3] != dh:
        raise ValueError(f"flash_attention: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)} do not fit")
    if k.dtype != v.dtype:
        raise ValueError(f"flash_attention: k is {k.dtype}, v {v.dtype}")
    if not 1 <= k.shape[1] <= H:
        raise ValueError(f"flash_attention: {k.shape[1]} kv heads for {H} "
                         f"query heads")
    if dh not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head_dim {dh} is not one of "
                         f"{HEAD_DIMS}")
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"flash_attention runs on CUDA or CPU tensors, not "
                         f"{q.device}")


def flash_attention_kernel(q, k, v, q_offset=None, *, causal: bool = True,
                           window: int = 0, scale: float | None = None):
    """q: [B, H, Sq, dh]; k, v: [B, Hkv, Skv, dh]. Returns [B, H, Sq, dh]
    in q's dtype. ``q_offset`` (an int or a one-element int tensor): the
    global position of q row 0, for chunked prefill against a longer kv
    cache. Counts each kernel launch in ``flash_attention_kernel.launches``
    and in ``launches_route1`` or ``launches_route2`` beside it.
    """
    _check(q, k, v)
    B, H, Sq, dh = q.shape
    _, Hkv, Skv, _ = k.shape
    off = 0 if q_offset is None else int(q_offset)
    scale = scale if scale is not None else dh ** -0.5
    if q.device.type == "cpu":
        return attention_reference(q, k, v, causal=causal, window=window,
                                   scale=scale, q_offset=off)
    out = torch.empty((B, H, Sq, dh), dtype=q.dtype, device=q.device)
    if out.numel() == 0:
        return out
    if Skv == 0:
        raise ValueError("flash_attention: no keys (Skv = 0)")
    # a view the kernel cannot read in place is copied here, not refused
    route, q, k, v = prepare(q, k, v)
    launch = _library(route)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    types = ([] if route == 1 else
             [int(q.dtype == torch.bfloat16), int(k.dtype == torch.bfloat16)])
    rc = launch(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                *types, B, H, Hkv, Sq, Skv, dh, *_strides(q), *_strides(k),
                *_strides(v), off, int(bool(causal)), int(window), scale,
                stream)
    if rc != 0:
        raise RuntimeError(f"flash_attention kernel (route {route}) launch "
                           f"failed: error {rc}")
    with _count_lock:
        flash_attention_kernel.launches += 1
        if route == 1:
            flash_attention_kernel.launches_route1 += 1
        else:
            flash_attention_kernel.launches_route2 += 1
    return out


# launches in all, and by route (route 1: wgmma, route 2: CUDA cores)
flash_attention_kernel.launches = 0
flash_attention_kernel.launches_route1 = 0
flash_attention_kernel.launches_route2 = 0


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, causal, window):
        ctx.save_for_backward(q, k, v)
        ctx.causal, ctx.window = causal, window
        return flash_attention_kernel(q, k, v, causal=causal, window=window)

    @staticmethod
    def backward(ctx, g):
        q, k, v = (t.detach().requires_grad_(True) for t in ctx.saved_tensors)
        with torch.enable_grad():
            out = attention_reference(q, k, v, causal=ctx.causal,
                                      window=ctx.window)
        dq, dk, dv = torch.autograd.grad(out, (q, k, v), g)
        return dq, dk, dv, None, None


def flash_attention(q, k, v, causal: bool = True, window: int = 0):
    """q: [B, H, Sq, dh]; k, v: [B, Hkv, Skv, dh]. Returns [B, H, Sq, dh].
    Forward through the kernel; the backward recomputes the plain version
    under autograd (there is no backward kernel, as in the JAX package)."""
    return _FlashAttention.apply(q, k, v, causal, window)
