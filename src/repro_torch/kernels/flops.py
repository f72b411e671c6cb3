"""FLOP tallies of the kernels' launches, read by ``compat.cost_analysis``.

``torch.utils.flop_counter.FlopCounterMode`` counts the aten operations
it sees. A kernel launched through ctypes is not one, so a K4 or K5
launch made while a count is open adds the FLOPs of its plain version at
the same shapes to its wrapper's tally (``flash_attention_kernel.flops``,
``ssd_scan_kernel.flops``): the count ``FlopCounterMode`` gives ``ref.py``
run on meta tensors of those shapes, computed once per shape. A count
then reads the same work whichever way the function ran: the kernel on
CUDA, the plain version on the CPU, shapes only on meta (where the
wrappers run ``ref.py`` and the counter sees it directly).

When no count is open a launch reads one attribute here and does nothing
more.
"""
from __future__ import annotations

import contextlib
import functools
import threading

import torch

_lock = threading.Lock()
open_counts = 0             # counts open now; a launch tallies while > 0


@contextlib.contextmanager
def counting():
    """Open a count for the duration of the block."""
    global open_counts
    with _lock:
        open_counts += 1
    try:
        yield
    finally:
        with _lock:
            open_counts -= 1


def add(fn, amount: int):
    """Add ``amount`` FLOPs to the tally of the wrapper ``fn``."""
    with _lock:
        fn.flops += amount


@functools.lru_cache(maxsize=1024)
def _plain_count(fn, key, specs):
    from torch.utils._python_dispatch import _disable_current_modes
    from torch.utils.flop_counter import FlopCounterMode
    args = [None if s is None else torch.empty(s[0], dtype=s[1],
                                               device="meta") for s in specs]
    # the count runs apart from any mode the caller has open
    with _disable_current_modes(), FlopCounterMode(display=False) as c:
        fn(*args, **dict(key))
    return c.get_total_flops()


def plain_flops(fn, tensors, **kwargs) -> int:
    """FLOPs ``FlopCounterMode`` counts for ``fn(*tensors, **kwargs)`` on
    meta tensors of the given tensors' shapes and dtypes (cached by them
    and by ``kwargs``, whose values must be hashable)."""
    specs = tuple(None if t is None else (tuple(t.shape), t.dtype)
                  for t in tensors)
    return _plain_count(fn, tuple(sorted(kwargs.items())), specs)
