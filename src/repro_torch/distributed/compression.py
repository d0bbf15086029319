"""Gradient compression for cross-pod reduction: int8 quantization with
error feedback (1-bit-Adam-style residual carrying).

Counterpart of ``repro.distributed.compression``, over dicts of tensors and
with its operations in its order, so q, scales and residuals are the
reference's bit for bit (``torch.round`` rounds half to even, as
``jnp.round``; a bf16 input is quantized in bf16, as the reference's).

At 1000+ node scale the data-parallel gradient reduce-scatter crosses the
slow inter-pod links; 8-bit block-quantized gradients cut that traffic 4x
(fp32) / 2x (bf16) with the residual error fed back into the next step so
the compression bias vanishes in expectation.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

Tree = Dict[str, torch.Tensor]


def quantize_int8(x: torch.Tensor, block: int = 256
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Blockwise symmetric int8 quantization. Returns (q, scales)."""
    flat = x.reshape(-1)
    pad = (-flat.shape[0]) % block
    if pad:
        flat = torch.cat([flat, flat.new_zeros(pad)])
    blocks = flat.reshape(-1, block)
    # a tensor divisor on x's device, not a Python number: CUDA divides by
    # a host scalar as a product with its reciprocal, which rounds apart
    # from the IEEE division the CPU (and the reference) take
    scale = (torch.amax(torch.abs(blocks), dim=1, keepdim=True)
             / torch.full((), 127.0, dtype=blocks.dtype, device=blocks.device))
    q = torch.clamp(torch.round(blocks / torch.clamp(scale, min=1e-12)),
                    -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor, shape,
                    dtype: torch.dtype) -> torch.Tensor:
    flat = (q.float() * scale).reshape(-1)
    n = 1
    for d in shape:
        n *= d
    return flat[:n].reshape(tuple(shape)).to(dtype)


def compress_tree(grads: Tree, residuals: Optional[Tree] = None):
    """Error-feedback compression of a dict of gradients.

    Returns ({name: (q, scale)}, new residuals)."""
    if residuals is None:
        residuals = {k: torch.zeros_like(g) for k, g in grads.items()}
    qtree, rtree = {}, {}
    for name, g in grads.items():
        g_corr = g.float() + residuals[name].float()
        q, s = quantize_int8(g_corr)
        deq = dequantize_int8(q, s, g.shape, torch.float32)
        qtree[name], rtree[name] = (q, s), g_corr - deq
    return qtree, rtree


def decompress_tree(qtree, like: Tree) -> Tree:
    return {name: dequantize_int8(q, s, like[name].shape, like[name].dtype)
            for name, (q, s) in qtree.items()}
