"""The port's one span and counter recorder.

Spans mark the layers of the pipeline engine (a step or call, a stage of
one microbatch, the optimizer, the blend, the blocks, the expert layer,
the head); counters count what those layers did (routes kept and
dropped). A benchmark's traced run reads them beside the profiler's
device trace.

Recording is on while a ``torch.profiler`` session records, or inside
``with recording():``. A step or call of the engine opens its root span
with ``unit``, which reads that switch once and holds the answer until
the root closes, so a step is recorded whole (its backward and its remat
recompute too) or not at all. When off, ``span`` returns one shared no-op
context after one bool check, ``grad_mark`` returns its tensor, and the
counters return: the program runs exactly as without them.

A span holds its name, its parent (the innermost span open on the same
thread, else the unit's root), the unit it belongs to, its phase and its
host start and end from ``time.time_ns()``, the clock the profiler stamps
its host events with. Its phase is ``fwd``, ``recompute`` when opened
while autograd runs a backward (non-reentrant checkpoint replays the
forward there) or ``bwd`` for the backward of a region between two
``grad_mark`` calls. A span given a CUDA ``device`` also records a pair
of CUDA events on the current stream; ``records`` puts them on one
device timeline in ms (from an anchor event of the recording). No
marker launches a kernel or synchronises, and none is a
``record_function`` range, so nothing of this shows in the device trace.
Records are kept until ``reset()`` (or a new ``recording()``): a process
that profiles many steps should reset between readings.
"""
from __future__ import annotations

import contextlib
import dataclasses
import itertools
import threading
import time

import torch
from torch.autograd import profiler as _profiler

_NOOP = contextlib.nullcontext()
_lock = threading.Lock()
_local = threading.local()      # .stack: the spans open on this thread
_unit_ids = itertools.count()

_forced = 0          # depth of ``recording()``
_root = None         # the open root span, while a unit records
_live = False        # spans record: ``_forced`` or a latched root

_spans: list = []
_counts: dict = {}
_tensor_counts: list = []       # (name, tensor, reduce), reduced when read
_anchor = None                  # the recording's first CUDA event


@dataclasses.dataclass(eq=False)
class Span:
    """One recorded span. ``device_ms`` is (start, end) on the
    recording's device timeline, or None (no CUDA markers)."""
    name: str
    parent: "Span | None" = None
    unit: int | None = None
    phase: str = "fwd"
    start_ns: int = 0
    end_ns: int = 0
    device_ms: tuple | None = None
    events: tuple | None = dataclasses.field(default=None, repr=False)


@dataclasses.dataclass
class Records:
    spans: list
    counters: dict


def _stack():
    try:
        return _local.stack
    except AttributeError:
        _local.stack = []
        return _local.stack


def _in_backward() -> bool:
    return torch._C._current_graph_task_id() >= 0


def _event(device):
    """A timing event recorded now on ``device``'s current stream (the
    recording's anchor first)."""
    global _anchor
    if _anchor is None:
        with _lock:
            if _anchor is None:
                anchor = torch.cuda.Event(enable_timing=True)
                anchor.record(torch.cuda.current_stream(device))
                _anchor = anchor
    ev = torch.cuda.Event(enable_timing=True)
    ev.record(torch.cuda.current_stream(device))
    return ev


def _cuda(device) -> bool:
    return device is not None and torch.device(device).type == "cuda"


class _Open:
    """A live span between its enter and exit."""
    __slots__ = ("span", "device", "root", "ev0")

    def __init__(self, name, device, root=False):
        self.span = Span(name)
        self.device = device if _cuda(device) else None
        self.root = root
        self.ev0 = None

    def __enter__(self):
        global _root, _live
        s, stack = self.span, _stack()
        if self.root:
            s.unit = next(_unit_ids)
            _root = s
            _live = True
        else:
            s.parent = stack[-1] if stack else _root
            s.unit = None if _root is None else _root.unit
            s.phase = "recompute" if _in_backward() else "fwd"
        stack.append(s)
        if self.device is not None:
            self.ev0 = _event(self.device)
        s.start_ns = time.time_ns()
        return s

    def __exit__(self, *exc):
        global _root, _live
        s = self.span
        s.end_ns = time.time_ns()
        if self.device is not None:
            s.events = (self.ev0, _event(self.device))
        _stack().pop()
        with _lock:
            _spans.append(s)
        if self.root:
            _root = None
            _live = bool(_forced)
        return False


def span(name: str, device=None):
    """A context recording the span ``name`` while recording is on; with
    a CUDA ``device``, also its interval on the device."""
    if not _live:
        return _NOOP
    return _Open(name, device)


def unit(name: str):
    """The root span of one step or call of the engine: reads the switch
    once. Opened inside another unit, a plain span."""
    if _root is not None:
        return span(name)
    if not (_forced or _profiler._is_profiler_enabled):
        return _NOOP
    return _Open(name, None, root=True)


# ------------------------------ backward marks ------------------------------

class _Region:
    """The backward of one marked region: begins when the output's
    gradient arrives, ends when the input's leaves."""
    __slots__ = ("span", "device", "ev0")

    def __init__(self, name, device):
        self.span = Span(name, phase="bwd")
        self.device = device if _cuda(device) else None
        self.ev0 = None

    def stamp(self, edge):
        s = self.span
        if edge == "out":
            stack = _stack()
            s.parent = stack[-1] if stack else _root
            s.unit = None if _root is None else _root.unit
            if self.device is not None:
                self.ev0 = _event(self.device)
            s.start_ns = time.time_ns()
            return
        if not s.start_ns:           # the output's gradient never came
            return
        s.end_ns = time.time_ns()
        if self.device is not None:
            s.events = (self.ev0, _event(self.device))
        with _lock:
            _spans.append(s)


class _Mark(torch.autograd.Function):
    """The identity; its backward stamps the region. Saves no tensor."""

    @staticmethod
    def forward(ctx, x, region, edge):
        ctx.region, ctx.edge = region, edge
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        ctx.region.stamp(ctx.edge)
        return g, None, None


def grad_mark(x, name: str, edge: str):
    """Mark a region's input (``edge="in"``) or output (``"out"``) in the
    forward; the region's backward interval is recorded as a ``bwd`` span
    ``name``. The identity, with no autograd node, while recording is
    off."""
    if not _live or not torch.is_grad_enabled() or not x.requires_grad:
        return x
    pending = getattr(_local, "pending", None)
    if pending is None:
        pending = _local.pending = {}
    if edge == "in":
        region = pending[name] = _Region(name, x.device)
    else:
        region = pending.pop(name, None)
        if region is None:
            return x
    return _Mark.apply(x, region, edge)


# --------------------------------- counters ---------------------------------

def count(name: str, n: int):
    """Add the host int ``n`` to counter ``name`` (forward only: not in
    remat's replay)."""
    if not _live or _in_backward():
        return
    with _lock:
        _counts[name] = _counts.get(name, 0) + n


def count_tensor(name: str, t, reduce):
    """Add ``reduce(t)`` to counter ``name``, worked out when the records
    are read (``t`` is kept until then; nothing runs on the device now).
    Forward only, as ``count``."""
    if not _live or _in_backward():
        return
    with _lock:
        _tensor_counts.append((name, t, reduce))


# --------------------------------- reading ----------------------------------

def records() -> Records:
    """Every finished span and the counters, device times resolved.
    Reading does not clear."""
    with _lock:
        spans = list(_spans)
        pending = list(_tensor_counts)
        _tensor_counts.clear()
        anchor = _anchor
    if anchor is not None and any(
            s.events is not None and s.device_ms is None for s in spans):
        torch.cuda.synchronize()
        for s in spans:
            if s.events is not None and s.device_ms is None:
                s.device_ms = (anchor.elapsed_time(s.events[0]),
                               anchor.elapsed_time(s.events[1]))
    for name, t, reduce in pending:
        n = reduce(t)
        with _lock:
            _counts[name] = _counts.get(name, 0) + n
    with _lock:
        counters = dict(_counts)
    return Records(spans, counters)


def reset():
    """Drop every record."""
    global _anchor
    with _lock:
        _spans.clear()
        _counts.clear()
        _tensor_counts.clear()
        _anchor = None


@contextlib.contextmanager
def recording():
    """Record inside this block, whatever the profiler does; clears the
    records on entry."""
    global _forced, _live
    reset()
    _forced += 1
    _live = True
    try:
        yield
    finally:
        _forced -= 1
        _live = bool(_forced) or _root is not None
