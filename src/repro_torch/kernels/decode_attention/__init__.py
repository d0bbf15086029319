from repro_torch.kernels.decode_attention.ops import decode_attention
from repro_torch.kernels.decode_attention.ref import decode_attention_reference

__all__ = ["decode_attention", "decode_attention_reference"]
