"""Wrappers of the fused SGD kernel: the flat-buffer update, the
whole-tree update (flatten, pack, one launch, unpack), and the flatten
helpers the live runtime's packed buffers are built on
(``runtime/stage_executor.py``).

``fused_sgd`` launches the CUDA kernel of ``csrc/fused_sgd.cu`` for tensors
on a CUDA device, and runs the plain version of ``ref.py`` for tensors on
the CPU. There is no other fallback: a CUDA tensor goes through the kernel
or the call raises.
"""
from __future__ import annotations

import ctypes
import math
import threading

import torch

from repro_torch import tree
from repro_torch.kernels import build
from repro_torch.kernels.fused_sgd.ref import sgd_reference

_count_lock = threading.Lock()     # worker threads launch concurrently


def pack_leaves(leaves) -> torch.Tensor:
    """Concatenate tree leaves into one flat f32 buffer."""
    return torch.cat([l.reshape(-1).to(torch.float32) for l in leaves])


def unpack_leaves(buf, shapes, dtypes, offset: int = 0) -> list:
    """Slice ``buf`` back into leaves of the given shapes/dtypes (views of
    ``buf`` where the dtype is already f32)."""
    out, off = [], offset
    for shape, dtype in zip(shapes, dtypes):
        n = math.prod(shape)
        out.append(buf[off:off + n].reshape(shape).to(dtype))
        off += n
    return out


def _library():
    lib = build.load("fused_sgd")
    fn = lib.fused_sgd_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 5 + [
            ctypes.c_longlong, ctypes.c_float, ctypes.c_float,
            ctypes.c_float, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def fused_sgd(p, g, m, *, lr, momentum=0.9, weight_decay=4e-5):
    """Flat [N] f32 update -> new tensors (p', m'). The inputs are never
    written. Counts each kernel launch in ``fused_sgd.launches``."""
    for name, t in (("g", g), ("m", m)):
        if t.shape != p.shape or t.device != p.device:
            raise ValueError(f"fused_sgd: {name} is {tuple(t.shape)} on "
                             f"{t.device}, p is {tuple(p.shape)} on "
                             f"{p.device}")
    for t in (p, g, m):
        if t.dtype != torch.float32 or t.dim() != 1 or not t.is_contiguous():
            raise ValueError(f"fused_sgd takes contiguous flat f32 buffers, "
                             f"got {t.dtype} {tuple(t.shape)} "
                             f"contiguous={t.is_contiguous()}")
    if p.device.type == "cpu":
        return sgd_reference(p, g, m, lr=lr, momentum=momentum,
                             weight_decay=weight_decay)
    if p.device.type != "cuda":
        raise ValueError(f"fused_sgd runs on CUDA or CPU tensors, not "
                         f"{p.device}")
    p_out, m_out = torch.empty_like(p), torch.empty_like(m)
    n = p.numel()
    if n == 0:
        return p_out, m_out
    launch = _library()
    stream = torch.cuda.current_stream(p.device).cuda_stream
    rc = launch(p.data_ptr(), g.data_ptr(), m.data_ptr(), p_out.data_ptr(),
                m_out.data_ptr(), n, lr, momentum, weight_decay, stream)
    if rc != 0:
        raise RuntimeError(f"fused_sgd kernel launch failed: CUDA error {rc}")
    with _count_lock:
        fused_sgd.launches += 1
    return p_out, m_out


fused_sgd.launches = 0


def fused_sgd_tree(params, grads, mom, *, lr, momentum=0.9,
                   weight_decay=4e-5):
    """Whole-tree fused update: one kernel launch over the concatenation."""
    leaves_p, paths = tree.flatten(params)
    shapes = [tuple(l.shape) for l in leaves_p]
    dtypes = [l.dtype for l in leaves_p]
    po, mo = fused_sgd(pack_leaves(leaves_p), pack_leaves(tree.leaves(grads)),
                       pack_leaves(tree.leaves(mom)), lr=lr,
                       momentum=momentum, weight_decay=weight_decay)
    return (tree.unflatten(paths, unpack_leaves(po, shapes, dtypes)),
            tree.unflatten(paths, unpack_leaves(
                mo, shapes, [torch.float32] * len(shapes))))
