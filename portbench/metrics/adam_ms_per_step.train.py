"""Device milliseconds a step of the optimizer: the stream time between
the device markers of the program's ``engine.optimizer`` span (Adam,
leaf by leaf, in ``make_train_step``), summed over the traced steps and
divided by their number. The cell is device-bound, so stream time there
is device time to within the idle share."""
from portbench import spans

UNIT = "ms"
LAYER = "optimizer"
SOURCE = "device_trace"
MOVES = "train_tokens_per_s"


def read(ctx):
    try:
        from repro_torch import obs
    except ImportError:          # a program without the recorder
        return None
    return spans.device_ms_per_unit(obs.records(), "engine.optimizer",
                                    ctx.trace.units)
