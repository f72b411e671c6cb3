"""Device milliseconds a step of the expert layer's forward: the stream
time between the device markers of the program's ``moe`` spans
(``moe_ffn`` whole: router, capacity dispatch, scatter, expert products,
gather), in the forward and in remat's replay of it, summed over the
traced steps and divided by their number."""
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
    return spans.device_ms_per_unit(obs.records(), "moe", ctx.trace.units,
                                    phases=("fwd", "recompute"))
