from repro_torch.kernels.moe_dispatch.ops import moe_combine, moe_dispatch
from repro_torch.kernels.moe_dispatch.ref import (moe_combine_grad_reference,
                                                  moe_combine_reference,
                                                  moe_dispatch_reference)

__all__ = ["moe_combine", "moe_dispatch", "moe_combine_grad_reference",
           "moe_combine_reference", "moe_dispatch_reference"]
