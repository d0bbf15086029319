from repro_torch.kernels.gla_scan.ops import gla_scan
from repro_torch.kernels.gla_scan.ref import gla_scan_reference

__all__ = ["gla_scan", "gla_scan_reference"]
