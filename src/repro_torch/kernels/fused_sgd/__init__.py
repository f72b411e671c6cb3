from repro_torch.kernels.fused_sgd.ops import fused_sgd, fused_sgd_tree
from repro_torch.kernels.fused_sgd.ref import sgd_reference
