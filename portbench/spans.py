"""Interval arithmetic over the program's own spans and counters
(``src/repro_torch/obs.py``), for the metrics that read them.

A traced run records spans only while the profiler runs, so every record
belongs to the traced steps or calls. A span's host interval
(``start_ns``, ``end_ns``) is on the clock of the profiler's host events
and of ``Trace`` (``time.time_ns()``); a span with device markers also
has ``device_ms``, its interval on the device's stream, in ms. This file
reads no program module: each reader imports the recorder inside its
``read`` and hands its records here.
"""
from __future__ import annotations


def union(intervals):
    """The union of (start, end) intervals, merged and sorted."""
    merged: list[list] = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        elif e > s:
            merged.append([s, e])
    return merged


def overlap(a, b) -> float:
    """The length of the intersection of two merged interval lists."""
    i = j = 0
    total = 0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if hi > lo:
            total += hi - lo
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def minus(a, b):
    """The merged intervals of ``a`` outside ``b`` (both merged)."""
    out, j = [], 0
    for s, e in a:
        while j < len(b) and b[j][1] <= s:
            j += 1
        k = j
        while k < len(b) and b[k][0] < e:
            if b[k][0] > s:
                out.append([s, b[k][0]])
            s = max(s, b[k][1])
            k += 1
        if e > s:
            out.append([s, e])
    return out


def device(spans, name: str, phases=None):
    """The device intervals (ms) of the spans ``name`` in ``phases``
    (all phases when None)."""
    return [s.device_ms for s in spans if s.name == name
            and s.device_ms is not None
            and (phases is None or s.phase in phases)]


def timed(spans) -> bool:
    """Whether any span carries device markers."""
    return any(s.device_ms is not None for s in spans)


def device_ms_per_unit(records, name: str, units: int, phases=None):
    """Device ms a unit between the markers of the spans ``name``; None
    without device-marked records."""
    if not timed(records.spans):
        return None
    return sum(e - s for s, e in device(records.spans, name, phases)) / units


def idle_gaps(trace):
    """The intervals (ns) of the traced span in which the device ran
    nothing: the complement of ``trace.busy_intervals()``."""
    edges = [trace.t0] + [x for s, e in trace.busy_intervals()
                          for x in (s, e)] + [trace.t1]
    return [[edges[i], edges[i + 1]] for i in range(0, len(edges), 2)
            if edges[i + 1] > edges[i]]


def host(spans, prefix: str):
    """The merged host intervals (ns) of the spans whose name starts with
    ``prefix``."""
    return union((s.start_ns, s.end_ns) for s in spans
                 if s.name.startswith(prefix))
