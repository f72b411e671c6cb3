"""Device milliseconds a step of the per-stage version blend: the stream
time between the device markers of the program's ``engine.blend`` span
(``_stage_window_blend`` on the steps that blend), summed over all
traced steps, blending or not, and divided by their number."""
from portbench import spans

UNIT = "ms"
LAYER = "pipeline engine"
SOURCE = "device_trace"
MOVES = "train_tokens_per_s"


def read(ctx):
    try:
        from repro_torch import obs
    except ImportError:          # a program without the recorder
        return None
    return spans.device_ms_per_unit(obs.records(), "engine.blend",
                                    ctx.trace.units)
