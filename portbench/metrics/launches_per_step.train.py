"""Device kernels launched a step: every kernel in the traced steps
(``trace.py``), over the number of steps. The engine's host dispatch
pays for each launch."""
UNIT = "launches"
LAYER = "pipeline engine"
SOURCE = "device_trace"
MOVES = "train_tokens_per_s"


def read(ctx):
    n = len(ctx.trace.kernels)
    return n / ctx.trace.units if n else None
