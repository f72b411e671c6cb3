"""The port's counterpart of ``repro.compat``.

Only ``cost_analysis`` has a meaning here. The JAX one reads XLA's
``Compiled.cost_analysis()``; this one runs the function under
``torch.utils.flop_counter.FlopCounterMode``, which counts the FLOPs of
the aten operations it sees by formula (matmuls, convolutions, attention:
2 per multiply-add; elementwise work is not counted). A launch of K4 or
K5 is not an aten operation, so each one made during the count adds the
FLOPs of its plain version at the same shapes (``kernels/flops.py``): the
count reads the same work whatever implements it, the kernel on CUDA,
the plain version on the CPU, or shapes only on the meta device.

Not applicable: ``shard_map`` and ``shard_map_is_legacy``. The port's
engine folds its mesh onto one device or runs one process a mesh
position (``pipeline/pipeline_step.py``); it maps no function over a
device mesh.
"""
from __future__ import annotations


def cost_analysis(fn, *args, **kwargs) -> dict:
    """Run ``fn(*args, **kwargs)`` once and count its FLOPs. Returns
    ``{"flops": total, "flops_aten": what the counter saw,
    "flops_kernels": {kernel: its launches' plain-version FLOPs}}``."""
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.kernels import flops as _flops
    from repro_torch.kernels.flash_attention.ops import flash_attention_kernel
    from repro_torch.kernels.ssm_scan.ops import ssd_scan_kernel

    kernels = {"flash_attention": flash_attention_kernel,
               "ssd_scan": ssd_scan_kernel}
    before = {name: k.flops for name, k in kernels.items()}
    with _flops.counting(), FlopCounterMode(display=False) as counter:
        fn(*args, **kwargs)
    by_kernel = {name: float(k.flops - before[name])
                 for name, k in kernels.items()}
    aten = float(counter.get_total_flops())
    return {"flops": aten + sum(by_kernel.values()), "flops_aten": aten,
            "flops_kernels": by_kernel}
