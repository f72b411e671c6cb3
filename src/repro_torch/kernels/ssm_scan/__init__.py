from repro_torch.kernels.ssm_scan.ops import ssd_scan, ssd_scan_kernel
from repro_torch.kernels.ssm_scan.ref import (ssd_scan_reference,
                                              ssd_scan_stepwise)
