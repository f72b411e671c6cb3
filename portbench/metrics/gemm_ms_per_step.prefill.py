"""Device milliseconds a call in the matrix products of the model:
the cuBLAS and CUTLASS GEMM and GEMV kernels, by the name fragments
below, summed over the traced calls and divided by their number."""
UNIT = "ms"
LAYER = "model"
SOURCE = "device_trace"
MOVES = "prefill_tokens_per_s"


GEMM_NAMES = ("gemm", "gemv", "nvjet", "xmma", "cutlass", "Kernel2")


def read(ctx):
    n, secs = ctx.trace.kernel_seconds(
        lambda name: any(g in name for g in GEMM_NAMES))
    return 1e3 * secs / ctx.trace.units if n else None
