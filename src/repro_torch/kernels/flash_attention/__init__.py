from repro_torch.kernels.flash_attention.ops import (FlashAttention,
                                                     flash_attention,
                                                     flash_attention_bwd,
                                                     flash_attention_fwd)
from repro_torch.kernels.flash_attention.ref import (
    attention_backward_reference, attention_forward_reference,
    attention_reference)

__all__ = ["FlashAttention", "flash_attention", "flash_attention_bwd",
           "flash_attention_fwd", "attention_backward_reference",
           "attention_forward_reference", "attention_reference"]
