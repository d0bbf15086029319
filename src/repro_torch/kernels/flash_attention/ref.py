"""Plain PyTorch version of the flash-attention kernel (materialized scores).

Counterpart of ``repro/kernels/flash_attention/ref.py``. The wrapper runs it
for CPU tensors; the tests and ``chip_smoke.py`` hold the kernel against it.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

NEG_INF = -1e30


def attention_reference(q, k, v, *, causal: bool = True,
                        window: Optional[int] = None):
    """q: (B, H, S, D); k/v: (B, KV, S, D). Returns (B, H, S, D)."""
    B, H, S, D = q.shape
    KV = k.shape[1]
    group = H // KV
    qg = q.reshape(B, KV, group, S, D).float()
    s = torch.einsum("bkgsd,bktd->bkgst", qg, k.float()) / math.sqrt(D)
    qpos = torch.arange(S, device=q.device)[:, None]
    kpos = torch.arange(S, device=q.device)[None, :]
    mask = torch.ones((S, S), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos <= qpos
    if window is not None:
        mask &= kpos > qpos - window
    s = s.masked_fill(~mask, NEG_INF)
    w = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgst,bktd->bkgsd", w, v.float())
    return o.reshape(B, H, S, D).to(q.dtype)
