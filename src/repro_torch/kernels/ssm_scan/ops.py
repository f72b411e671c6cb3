"""Wrappers of the SSD scan kernel (K5): the counterpart of
``repro.kernels.ssm_scan.kernel.ssd_scan_kernel`` (with an initial state
``h0`` and the final state out, as the jnp ``ssd_chunked`` the Mamba2
mixer calls takes and returns) and of ``repro.kernels.ssm_scan.ops.ssd_scan``
(an autograd function whose backward recomputes the plain version, as the
JAX package's custom VJP does with ``jax.vjp``).

``ssd_scan_kernel`` launches the CUDA kernels of ``csrc/ssd_scan.cu`` for
tensors on a CUDA device, and runs the plain version of ``ref.py`` for
tensors on the CPU. There is no other fallback: a CUDA tensor goes through
the kernel or the call raises. Nothing is padded on the card: the kernel
reads positions past S as dt = 0 (exact, see ``ref.ssd_scan_reference``).
"""
from __future__ import annotations

import ctypes
import threading

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ssm_scan.ref import ssd_scan_reference

CHUNK = 128                 # the kernel's chunk length
P_BLOCK = 32                # P is split into blocks of 32 columns
STATE_SIZES = (16, 32, 64, 128)     # the kernel's instances of N
DTYPES = (torch.float32, torch.bfloat16)
_count_lock = threading.Lock()


def _library():
    fn = build.load("ssd_scan").ssd_scan_launch
    if fn.argtypes is None:
        vp, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn.argtypes = [vp] * 10 + [i] * 7 + [ll] * 10 + [vp]
        fn.restype = ctypes.c_int
    return fn


def _check(xh, dt, A, Bm, Cm, D, h0):
    named = (("xh", xh, 4), ("dt", dt, 3), ("A", A, 1), ("Bm", Bm, 3),
             ("Cm", Cm, 3), ("D", D, 1))
    if h0 is not None:
        named += (("h0", h0, 4),)
    for name, t, nd in named:
        if not torch.is_tensor(t) or t.dim() != nd:
            raise ValueError(f"ssd_scan: {name} must be a {nd}-D tensor")
        if t.dtype not in DTYPES:
            raise ValueError(f"ssd_scan: {name} is {t.dtype}, not f32 or "
                             f"bf16")
        if t.device != xh.device:
            raise ValueError(f"ssd_scan: {name} is on {t.device}, xh on "
                             f"{xh.device}")
    B, S, H, P = xh.shape
    N = Bm.shape[-1]
    if (tuple(dt.shape) != (B, S, H) or tuple(A.shape) != (H,)
            or tuple(D.shape) != (H,) or tuple(Bm.shape) != (B, S, N)
            or tuple(Cm.shape) != (B, S, N)
            or (h0 is not None and tuple(h0.shape) != (B, H, P, N))):
        raise ValueError(
            f"ssd_scan: shapes do not fit: xh {tuple(xh.shape)}, dt "
            f"{tuple(dt.shape)}, A {tuple(A.shape)}, Bm {tuple(Bm.shape)}, "
            f"Cm {tuple(Cm.shape)}, D {tuple(D.shape)}"
            + ("" if h0 is None else f", h0 {tuple(h0.shape)}"))
    if xh.device.type not in ("cpu", "cuda"):
        raise ValueError(f"ssd_scan runs on CUDA or CPU tensors, not "
                         f"{xh.device}")


def _check_cuda(xh, dt, Bm, Cm, chunk):
    P, N = xh.shape[3], Bm.shape[2]
    if chunk != CHUNK:
        raise ValueError(f"ssd_scan: the kernel's chunk is {CHUNK}, not "
                         f"{chunk}")
    if P % P_BLOCK:
        raise ValueError(f"ssd_scan: head dim P={P} is not a multiple of "
                         f"{P_BLOCK}")
    if N not in STATE_SIZES:
        raise ValueError(f"ssd_scan: state size N={N} is not one of "
                         f"{STATE_SIZES}")
    if not dt.dtype == Bm.dtype == Cm.dtype:
        raise ValueError(f"ssd_scan: dt, Bm, Cm are {dt.dtype}, "
                         f"{Bm.dtype}, {Cm.dtype}: the kernel reads them "
                         f"in one type")


def ssd_scan_kernel(xh, dt, A, Bm, Cm, D, chunk: int = CHUNK, h0=None,
                    return_state: bool = False):
    """xh: [B, S, H, P]; dt: [B, S, H] (post-softplus); A, D: [H];
    Bm, Cm: [B, S, N]; h0: [B, H, P, N] or None (zeros). Returns y
    [B, S, H, P] in xh's dtype or, with ``h0`` or ``return_state``,
    (y, h_final [B, H, P, N] f32). Any S: the ragged tail is masked.
    Counts each launch in ``ssd_scan_kernel.launches`` (one a call: the
    C.B^T pass and the scan it feeds)."""
    _check(xh, dt, A, Bm, Cm, D, h0)
    want_state = h0 is not None or return_state
    if xh.device.type == "cpu":
        return ssd_scan_reference(xh, dt, A, Bm, Cm, D, chunk=chunk, h0=h0,
                                  return_state=return_state)
    _check_cuda(xh, dt, Bm, Cm, chunk)
    B, S, H, P = xh.shape
    N = Bm.shape[-1]
    dev = xh.device
    y = torch.empty((B, S, H, P), dtype=xh.dtype, device=dev)
    if y.numel() == 0:
        if not want_state:
            return y
        return y, (torch.zeros((B, H, P, N), dtype=torch.float32, device=dev)
                   if h0 is None else h0.to(torch.float32).clone())
    hfin = (torch.empty((B, H, P, N), dtype=torch.float32, device=dev)
            if want_state else None)
    xh, Bm, Cm = (t if t.stride(-1) == 1 else t.contiguous()
                  for t in (xh, Bm, Cm))
    A, D = (t.to(torch.float32).contiguous() for t in (A, D))
    if h0 is not None:
        h0 = h0.to(torch.float32).contiguous()
    cb = torch.empty((B, -(-S // CHUNK), CHUNK, CHUNK), dtype=torch.float32,
                     device=dev)
    launch = _library()
    stream = torch.cuda.current_stream(dev).cuda_stream
    bf = torch.bfloat16
    rc = launch(xh.data_ptr(), dt.data_ptr(), A.data_ptr(), Bm.data_ptr(),
                Cm.data_ptr(), D.data_ptr(),
                None if h0 is None else h0.data_ptr(), y.data_ptr(),
                None if hfin is None else hfin.data_ptr(), cb.data_ptr(),
                int(xh.dtype == bf), int(dt.dtype == bf), B, S, H, P, N,
                *xh.stride()[:3], *dt.stride(), *Bm.stride()[:2],
                *Cm.stride()[:2], stream)
    if rc != 0:
        raise RuntimeError(f"ssd_scan kernel launch failed: CUDA error {rc}")
    with _count_lock:
        ssd_scan_kernel.launches += 1
    return (y, hfin) if want_state else y


ssd_scan_kernel.launches = 0


class _SSDScan(torch.autograd.Function):
    @staticmethod
    def forward(ctx, xh, dt, A, Bm, Cm, D, h0, chunk, want_state):
        ctx.save_for_backward(xh, dt, A, Bm, Cm, D, h0)
        ctx.chunk, ctx.want_state = chunk, want_state
        return ssd_scan_kernel(xh, dt, A, Bm, Cm, D, chunk, h0,
                               return_state=want_state)

    @staticmethod
    def backward(ctx, *grads):
        saved = ctx.saved_tensors
        ins = [None if t is None else t.detach().requires_grad_(need)
               for t, need in zip(saved, ctx.needs_input_grad)]
        with torch.enable_grad():
            outs = ssd_scan_reference(*ins[:6], chunk=ctx.chunk, h0=ins[6],
                                      return_state=ctx.want_state)
        outs = outs if ctx.want_state else (outs,)
        pairs = [(o, g) for o, g in zip(outs, grads) if g is not None]
        wrt = [t for t, need in zip(ins, ctx.needs_input_grad[:7]) if need]
        got = iter(torch.autograd.grad([o for o, _ in pairs],
                                       wrt, [g for _, g in pairs],
                                       allow_unused=True))
        return (*(next(got) if need else None
                  for need in ctx.needs_input_grad[:7]), None, None)


def ssd_scan(xh, dt, A, Bm, Cm, D, chunk: int = CHUNK, h0=None,
             return_state: bool = False):
    """xh: [B, S, H, P]; dt: [B, S, H]; A, D: [H]; Bm, Cm: [B, S, N] ->
    y [B, S, H, P], or (y, h_final) with ``h0`` or ``return_state``.
    Forward through the kernel; the backward recomputes the plain version
    under autograd (there is no backward kernel, as in the JAX package)."""
    return _SSDScan.apply(xh, dt, A, Bm, Cm, D, h0, chunk,
                          h0 is not None or return_state)
