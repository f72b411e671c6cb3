from repro_torch.kernels.moe_combine.ops import moe_combine
from repro_torch.kernels.moe_combine.ref import combine_reference
