"""Device milliseconds a step of the expert layer's backward: each
``moe`` region's backward on the device's stream, from its output's
gradient arriving to its input's leaving (the program's grad marks),
less the part of it in which remat replayed a stage (``engine.stage``
spans of phase ``recompute``), summed over the traced steps and divided
by their number. The gather's backward (``indexing_backward_kernel``)
lies inside."""
from portbench import spans

UNIT = "ms"
LAYER = "model: experts"
SOURCE = "device_trace"
MOVES = "train_tokens_per_s"


def read(ctx):
    try:
        from repro_torch import obs
    except ImportError:          # a program without the recorder
        return None
    rec = obs.records()
    if not spans.timed(rec.spans):
        return None
    replay = spans.union(spans.device(rec.spans, "engine.stage",
                                      ("recompute",)))
    total = 0.0
    for s, e in spans.device(rec.spans, "moe", ("bwd",)):
        total += (e - s) - spans.overlap([[s, e]], replay)
    return total / ctx.trace.units
