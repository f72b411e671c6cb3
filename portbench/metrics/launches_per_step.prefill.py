"""Device kernels launched a call: every kernel in the traced calls
(``trace.py``), over the number of calls. The engine's host dispatch
pays for each launch."""
UNIT = "launches"
LAYER = "pipeline engine"
SOURCE = "device_trace"
MOVES = "prefill_tokens_per_s"


def read(ctx):
    n = len(ctx.trace.kernels)
    return n / ctx.trace.units if n else None
