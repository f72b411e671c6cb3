"""Model-FLOP utilisation of the whole call: the model FLOPs of a call
worked out from the configuration's shapes (``flops.py``), times the
calls a second of the untraced window, over the bf16 peak
(``peaks.py``). Recomputation is not counted."""
from portbench import peaks

UNIT = "%"
LAYER = "whole step"
SOURCE = "host_clock"
MOVES = "prefill_tokens_per_s"


def read(ctx):
    per_s = ctx.rate / ctx.tokens_per_unit
    return 100.0 * per_s * ctx.kind.flops_per_unit(ctx.config, ctx.mix) \
        / peaks.PEAK_FLOPS_BF16
