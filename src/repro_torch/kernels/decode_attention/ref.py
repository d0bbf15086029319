"""Plain PyTorch version of the decode-attention kernel.

Counterpart of ``repro/kernels/decode_attention/ref.py``. The wrapper runs it
for CPU tensors; the tests and ``chip_smoke.py`` hold the kernel against it.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

NEG_INF = -1e30


def decode_attention_reference(q, k_cache, v_cache, lengths, *,
                               window: Optional[int] = None):
    """q: (B, KV, G, D); caches: (B, KV, W, D); lengths: (B,)."""
    D = q.shape[-1]
    W = k_cache.shape[2]
    s = torch.einsum("bkgd,bktd->bkgt", q.float(), k_cache.float()) / math.sqrt(D)
    slot = torch.arange(W, device=q.device)[None, :]
    if window is None:
        valid = slot < lengths[:, None]
    else:
        valid = slot < torch.clamp(lengths, max=window)[:, None]
    s = s.masked_fill(~valid[:, None, None, :], NEG_INF)
    w = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgt,bktd->bkgd", w, v_cache.float())
    return o.to(q.dtype)
