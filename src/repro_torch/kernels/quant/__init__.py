from repro_torch.kernels.quant.ops import dequantize, quantize_ef
from repro_torch.kernels.quant.ref import (dequantize_reference,
                                           quantize_ef_reference)
