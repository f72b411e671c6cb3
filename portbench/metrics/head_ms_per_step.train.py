"""Device milliseconds a step of the head: the stream time of the
program's ``head`` span (final norm, the f32 head product, the
cross-entropy) plus its backward between the head's grad marks, summed
over the traced steps and divided by their number."""
from portbench import spans

UNIT = "ms"
LAYER = "model: head"
SOURCE = "device_trace"
MOVES = "train_tokens_per_s"


def read(ctx):
    try:
        from repro_torch import obs
    except ImportError:          # a program without the recorder
        return None
    return spans.device_ms_per_unit(obs.records(), "head", ctx.trace.units)
