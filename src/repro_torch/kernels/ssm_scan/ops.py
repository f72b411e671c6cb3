"""Wrappers of the SSD scan kernel (K5): the counterpart of
``repro.kernels.ssm_scan.kernel.ssd_scan_kernel`` (with an initial state
``h0`` and the final state out, as the jnp ``ssd_chunked`` the Mamba2
mixer calls takes and returns) and of ``repro.kernels.ssm_scan.ops.ssd_scan``
(an autograd function whose backward recomputes the plain version, as the
JAX package's custom VJP does with ``jax.vjp``).

``ssd_scan_kernel`` launches the CUDA kernels of ``csrc/ssd_scan.cu`` for
tensors on a CUDA device (three passes: chunk states, the state passed
across chunks, chunk outputs; ``launch_plan`` says what each is given),
and runs the plain version of ``ref.py`` for tensors on the CPU and on
the meta device (where it gives shapes only: meta computes nothing).
There is no other fallback: a CUDA tensor goes through the kernels or the
call raises. Nothing is padded on the card: the kernels read positions
past S as dt = 0 (exact, see ``ref.ssd_scan_reference``). While a FLOP
count is open (``compat.cost_analysis``), each launch adds its plain
version's FLOPs to ``ssd_scan_kernel.flops`` (``kernels/flops.py``).
"""
from __future__ import annotations

import ctypes
import functools
import threading
from typing import NamedTuple

import torch

from repro_torch.kernels import build, tma
from repro_torch.kernels import flops as _flops
from repro_torch.kernels.ssm_scan.ref import ssd_scan_reference

CHUNK = 128                 # the kernel's chunk length
P_MULTIPLE = 32             # P must be a multiple of 32
STATE_SIZES = (16, 32, 64, 128)     # the N the kernels take
DTYPES = (torch.float32, torch.bfloat16)
SMS = 132                   # streaming multiprocessors of an H100 SXM
MAX_HEADS_PER_BLOCK = 16
_count_lock = threading.Lock()


def _library():
    fn = build.load("ssd_scan").ssd_scan_launch
    if fn.argtypes is None:
        vp, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn.argtypes = [vp] * 11 + [i] * 10 + [ll] * 10 + [vp]
        fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=256)
def heads_per_block(chunks: int, H: int, sms: int = SMS) -> int:
    """Heads one block of pass 1 or 3 takes, for ``chunks`` (batch row,
    chunk) pairs: the count whose blocks fill the card's waves best, one
    block an SM, each block paying about one head's work of its own
    (loading B and C, and C.B^T in pass 3). The smallest such count."""
    best = None
    for g in range(1, min(H, MAX_HEADS_PER_BLOCK) + 1):
        blocks = chunks * -(-H // g)
        cost = -(-blocks // sms) * (g + 1)
        if best is None or cost < best[0]:
            best = (cost, g)
    return best[1]


class Plan(NamedTuple):
    copy: tuple             # (xh, Bm, Cm): copied first, TMA cannot read it
    state_chunks: int       # chunks whose state pass 1 computes
    heads_state: int        # heads a block of pass 1
    heads_out: int          # heads a block of pass 3
    states: tuple           # f32 scratch [B, nc, H, P, N]: s_c, then h_in
    decays: tuple           # f32 scratch [B, nc, H]: exp(cum) at chunk end


def launch_plan(xh, Bm, Cm, want_state: bool, sms: int = SMS) -> Plan:
    """What the kernels are given, from the shapes, strides and base
    alignment alone. xh, Bm and Cm are read by TMA (``tma.ready``); one
    that TMA cannot read is copied. The views the Mamba2 mixer passes
    (slices of its conv output, an s-stride of d_inner + 2N floats) need
    no copy. The last chunk's state only feeds h_final, so pass 1 skips it
    unless the state is wanted."""
    B, S, H, P = xh.shape
    N = Bm.shape[-1]
    nc = -(-S // CHUNK)
    nc1 = nc if want_state else nc - 1
    return Plan(copy=tuple(not tma.ready(t) for t in (xh, Bm, Cm)),
                state_chunks=nc1,
                heads_state=heads_per_block(B * max(nc1, 1), H, sms),
                heads_out=heads_per_block(B * nc, H, sms),
                states=(B, nc, H, P, N), decays=(B, nc, H))


@functools.lru_cache(maxsize=16)
def _sm_count(dev) -> int:
    return torch.cuda.get_device_properties(dev).multi_processor_count


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
    if xh.device.type not in ("cpu", "cuda", "meta"):
        raise ValueError(f"ssd_scan runs on CUDA, CPU or meta tensors, not "
                         f"{xh.device}")


def _check_cuda(xh, dt, Bm, Cm, chunk):
    P, N = xh.shape[3], Bm.shape[2]
    if chunk != CHUNK:
        raise ValueError(f"ssd_scan: the kernel's chunk is {CHUNK}, not "
                         f"{chunk}")
    if P % P_MULTIPLE:
        raise ValueError(f"ssd_scan: head dim P={P} is not a multiple of "
                         f"{P_MULTIPLE}")
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
    Counts each call in ``ssd_scan_kernel.launches`` (one a call: its
    three passes feed one another), and while a count is open its plain
    version's FLOPs in ``.flops``."""
    _check(xh, dt, A, Bm, Cm, D, h0)
    want_state = h0 is not None or return_state
    if xh.device.type != "cuda":        # the CPU, or meta (shapes only)
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
    plan = launch_plan(xh, Bm, Cm, want_state, _sm_count(dev))
    # a view TMA cannot read is copied here, not refused (a clone:
    # .contiguous() would keep a contiguous tensor's misaligned base)
    xh, Bm, Cm = (t.clone(memory_format=torch.contiguous_format) if c else t
                  for t, c in zip((xh, Bm, Cm), plan.copy))
    hfin = (torch.empty((B, H, P, N), dtype=torch.float32, device=dev)
            if want_state else None)
    A, D = (t.to(torch.float32).contiguous() for t in (A, D))
    if h0 is not None:
        h0 = h0.to(torch.float32).contiguous()
        if h0.data_ptr() % 16:          # read four values at a time
            h0 = h0.clone()
    states = torch.empty(plan.states, dtype=torch.float32, device=dev)
    decays = torch.empty(plan.decays, dtype=torch.float32, device=dev)
    launch = _library()
    stream = torch.cuda.current_stream(dev).cuda_stream
    bf = torch.bfloat16
    rc = launch(xh.data_ptr(), dt.data_ptr(), A.data_ptr(), Bm.data_ptr(),
                Cm.data_ptr(), D.data_ptr(),
                None if h0 is None else h0.data_ptr(), y.data_ptr(),
                None if hfin is None else hfin.data_ptr(), states.data_ptr(),
                decays.data_ptr(), int(xh.dtype == bf), int(dt.dtype == bf),
                B, S, H, P, N, plan.heads_state, plan.heads_out,
                int(want_state), *tma.strides(xh), *dt.stride(),
                *tma.strides(Bm, 2), *tma.strides(Cm, 2), stream)
    if rc != 0:
        raise RuntimeError(f"ssd_scan kernel launch failed: error {rc}")
    with _count_lock:
        ssd_scan_kernel.launches += 1
    if _flops.open_counts:
        _flops.add(ssd_scan_kernel, _flops.plain_flops(
            ssd_scan_reference, (xh, dt, A, Bm, Cm, D, h0), chunk=chunk,
            return_state=bool(return_state)))
    return (y, hfin) if want_state else y


ssd_scan_kernel.launches = 0
# the plain version's FLOPs of the launches made while a count was open
ssd_scan_kernel.flops = 0


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
