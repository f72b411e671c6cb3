"""Flash attention's (K4's) share of its roofline: the least time the
card could take for the launches traced, over their device time. Each
launch's work comes from the cell's shapes (``flops.py``): 4 head_dim
FLOPs a kept (query, key) pair and head, q, k, v and o moved once; its
least time is the larger of FLOPs over the bf16 peak and bytes over
HBM's. Kernels ``flash_fwd_sm90`` (route 1) and ``flash_fwd_tf32``
(route 2)."""
from portbench import flops, peaks

UNIT = "%"
LAYER = "kernel K4"
SOURCE = "device_trace"
MOVES = "train_tokens_per_s"


def read(ctx):
    n, secs = ctx.trace.kernel_seconds(lambda name: "flash_fwd_" in name)
    if not n:
        return None
    f, b = flops.attention_kernel_work(
        *ctx.kind.attention_launch(ctx.config, ctx.mix))
    least = max(f / peaks.PEAK_FLOPS_BF16, b / peaks.HBM_BYTES_PER_S)
    return 100.0 * n * least / secs
