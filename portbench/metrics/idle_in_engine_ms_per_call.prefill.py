"""Device idle milliseconds a call while the host was in the engine
outside any block: the traced span's idle gaps (the complement of the
device's busy intervals) that the host spent under one of the program's
``engine.*`` spans (the call, a stage: the tick loop, hand-off casts,
``cat``, the head) with no ``block.*`` span open, on the clock the
profiler and the spans share, over the traced calls."""
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
    engine = spans.minus(spans.host(rec, "engine."),
                         spans.host(rec, "block."))
    ns = spans.overlap(spans.idle_gaps(ctx.trace), engine)
    return ns / 1e6 / ctx.trace.units
