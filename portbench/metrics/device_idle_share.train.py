"""Share of the traced span in which the device ran nothing: 1 - the
union of its kernel, copy and fill intervals over the span (``trace.py``;
the span ends with a synchronise). The profiler's host overhead lengthens
the span, so this reads above the share of an untraced step."""
UNIT = "%"
LAYER = "device"
SOURCE = "device_trace"
MOVES = "train_tokens_per_s"


def read(ctx):
    return 100.0 * (1.0 - ctx.trace.busy_s / ctx.trace.window_s)
