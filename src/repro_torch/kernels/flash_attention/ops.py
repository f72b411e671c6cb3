"""Wrappers of the flash attention kernel (K4): the counterpart of
``repro.kernels.flash_attention.kernel.flash_attention_kernel`` (with a
``q_offset``, for chunked prefill) and of
``repro.kernels.flash_attention.ops.flash_attention`` (an autograd
function whose backward recomputes the plain version, as the JAX package's
custom VJP does with ``jax.vjp``).

``flash_attention_kernel`` launches the CUDA kernel of
``csrc/flash_attention.cu`` for tensors on a CUDA device, and runs the
plain version of ``ref.py`` for tensors on the CPU. There is no other
fallback: a CUDA tensor goes through the kernel or the call raises. Nothing
is padded: the kernel masks the true sequence edges.
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


def _library():
    fn = build.load("flash_attention").flash_attention_launch
    if fn.argtypes is None:
        vp, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn.argtypes = ([vp] * 4 + [i] * 8 + [ll] * 9
                       + [i, i, i, ctypes.c_float, vp])
        fn.restype = ctypes.c_int
    return fn


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
    cache. Counts each kernel launch in ``flash_attention_kernel.launches``.
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
    q, k, v = (t if t.stride(-1) == 1 else t.contiguous() for t in (q, k, v))
    launch = _library()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    bf = torch.bfloat16
    rc = launch(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                int(q.dtype == bf), int(k.dtype == bf), B, H, Hkv, Sq, Skv,
                dh, *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], off,
                int(bool(causal)), int(window), scale, stream)
    if rc != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: CUDA "
                           f"error {rc}")
    with _count_lock:
        flash_attention_kernel.launches += 1
    return out


flash_attention_kernel.launches = 0


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
