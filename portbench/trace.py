"""What the device did while a few steps ran under ``torch.profiler``.

``capture`` runs a callable a few times inside a ``portbench.traced``
span that ends with a synchronise, so the span covers all the device work
of those calls. ``Trace`` keeps each device interval (kernels, copies,
fills) and each host operation, and derives the per-layer readings the
metrics of ``metrics/`` take: kernels by name, the union of busy device
time, and the idle gaps between device intervals named by what the host
was doing then.
"""
from __future__ import annotations

import bisect
import collections
import dataclasses

SPAN = "portbench.traced"


@dataclasses.dataclass
class Trace:
    units: int                       # steps or calls traced
    t0: int                          # span start, ns (profiler clock)
    t1: int                          # span end, ns
    kernels: list                    # [(name, start_ns, end_ns)]
    copies: list                     # memcpy / memset intervals, same form
    host: list                       # [(name, start_ns, end_ns)] host ops

    @property
    def window_s(self) -> float:
        return (self.t1 - self.t0) / 1e9

    def busy_intervals(self):
        """The union of device intervals inside the span, merged."""
        spans = sorted((max(s, self.t0), min(e, self.t1))
                       for _, s, e in self.kernels + self.copies
                       if e > self.t0 and s < self.t1)
        merged: list[list[int]] = []
        for s, e in spans:
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        return merged

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy_intervals()) / 1e9

    def kernel_seconds(self, match) -> tuple[int, float]:
        """(launches, device seconds) of the kernels whose name ``match``
        accepts."""
        sel = [(s, e) for n, s, e in self.kernels if match(n)]
        return len(sel), sum(e - s for s, e in sel) / 1e9

    def device_ops(self, top: int = 10):
        """[[name, seconds]] of the device operations that took most time,
        summed by name."""
        by = collections.Counter()
        for n, s, e in self.kernels + self.copies:
            by[n] += (e - s) / 1e9
        return [[n[:160], t] for n, t in by.most_common(top)]

    def idle_gaps(self, top: int = 10):
        """[[name, seconds]] of the longest gaps with no device work inside
        the span, each named by the innermost host operation running at
        its middle (``aten::`` ones first); "host between operations"
        where none ran (the host was in Python between two)."""
        busy = self.busy_intervals()
        edges = [self.t0] + [x for s, e in busy for x in (s, e)] + [self.t1]
        gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
                if edges[i + 1] > edges[i]]
        gaps.sort(key=lambda g: g[0] - g[1])
        host = sorted(self.host, key=lambda h: h[1])
        starts = [h[1] for h in host]
        out = []
        for s, e in gaps[:top]:
            mid = (s + e) // 2
            i = bisect.bisect_right(starts, mid)
            live = [h for h in host[max(0, i - 4000):i] if h[2] >= mid]
            aten = [h for h in live if h[0].startswith("aten::")]
            pick = min(aten or live, key=lambda h: h[2] - h[1], default=None)
            out.append([pick[0][:160] if pick else "host between operations",
                        (e - s) / 1e9])
        return out


def capture(fn, units: int) -> Trace:
    """Run ``fn(i)`` for i in range(units) under the profiler; return the
    trace of the span around them."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with record_function(SPAN):
            for i in range(units):
                fn(i)
            torch.cuda.synchronize()
    kernels, copies, host = [], [], []
    t0 = t1 = None
    for ev in prof.profiler.kineto_results.events():
        name, start = ev.name(), ev.start_ns()
        end = start + ev.duration_ns()
        if ev.device_type() == torch.autograd.DeviceType.CUDA:
            if name == SPAN:             # the span's copy on the device
                continue
            low = name.lower()
            (copies if "memcpy" in low or "memset" in low
             else kernels).append((name, start, end))
        elif name == SPAN:
            t0, t1 = start, end
        else:
            host.append((name, start, end))
    if t0 is None:
        raise RuntimeError("the profiler recorded no portbench.traced span")
    return Trace(units, t0, t1, kernels, copies, host)
