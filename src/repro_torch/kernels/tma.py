"""What the port's TMA tensor maps need of a tensor, shared by the
wrappers of the kernels that load through them (both routes of flash
attention, the SSD scan)."""
from __future__ import annotations


def ready(t) -> bool:
    """A contiguous last axis, a 16-byte aligned base, and the other
    strides multiples of 16 bytes (a stride over a dimension of size 1 is
    never used)."""
    return (t.stride(-1) == 1 and t.data_ptr() % 16 == 0
            and all(n == 1 or st * t.element_size() % 16 == 0
                    for n, st in zip(t.shape[:-1], t.stride()[:-1])))


def strides(t, n: int = 3):
    """t's first ``n`` strides, with the stride of a dimension of size 1
    replaced by one TMA accepts (it is never multiplied)."""
    outer = max(st * k for k, st in zip(t.shape, t.stride()) if k > 1)
    return [st if k > 1 else outer
            for k, st in zip(t.shape[:n], t.stride()[:n])]
