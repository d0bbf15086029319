from repro_torch.kernels.microgrid_scan.ops import microgrid_scan
from repro_torch.kernels.microgrid_scan.ref import microgrid_scan_reference

__all__ = ["microgrid_scan", "microgrid_scan_reference"]
