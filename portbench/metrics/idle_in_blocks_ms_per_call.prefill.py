"""Device idle milliseconds a call while the host was inside a block:
the traced span's idle gaps (the complement of the device's busy
intervals) that the host spent under one of the program's ``block.*``
spans (``Dense.apply``, ``Moe.apply``: norm, mixer or FFN, residual
blend), on the clock the profiler and the spans share, over the traced
calls."""
from portbench import spans

UNIT = "ms"
LAYER = "device"
SOURCE = "device_trace"
MOVES = "prefill_tokens_per_s"


def read(ctx):
    try:
        from repro_torch import obs
    except ImportError:          # a program without the recorder
        return None
    rec = obs.records().spans
    if not rec:
        return None
    blocks = spans.host(rec, "block.")
    ns = spans.overlap(spans.idle_gaps(ctx.trace), blocks)
    return ns / 1e6 / ctx.trace.units
