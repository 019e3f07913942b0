from repro_torch.kernels.ssm_scan.ops import gla_scan
from repro_torch.kernels.ssm_scan.ref import gla_scan_ref

__all__ = ["gla_scan", "gla_scan_ref"]
