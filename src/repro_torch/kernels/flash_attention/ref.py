"""Plain PyTorch versions of the flash-attention kernels (materialized scores).

Counterpart of ``repro/kernels/flash_attention/ref.py`` (the forward) and of
``repro/models/attention.py::_flash_bwd_padded`` (the backward, which the
reference writes in XLA under a custom VJP). The wrappers run them for CPU
tensors; the tests and ``chip_smoke.py`` hold the kernels against them.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

NEG_INF = -1e30


def _mask(qpos: torch.Tensor, kpos: torch.Tensor, causal: bool,
          window: Optional[int]) -> torch.Tensor:
    """(len(qpos), len(kpos)) visibility: causal kpos <= qpos, window
    kpos > qpos - window."""
    mask = torch.ones((len(qpos), len(kpos)), dtype=torch.bool,
                      device=qpos.device)
    if causal:
        mask &= kpos[None, :] <= qpos[:, None]
    if window is not None:
        mask &= kpos[None, :] > qpos[:, None] - window
    return mask


def attention_forward_reference(q, k, v, *, causal: bool = True,
                                window: Optional[int] = None):
    """q: (B, H, S, D); k/v: (B, KV, S, D). Returns (o (B, H, S, D) in q's
    dtype, lse (B, H, S)): each row's natural-log sum of exp(q k^T /
    sqrt(D)) over its visible keys. It computes in float32, or in float64
    for float64 inputs (lse in that dtype)."""
    B, H, S, D = q.shape
    KV = k.shape[1]
    group = H // KV
    dt = torch.promote_types(q.dtype, torch.float32)
    qg = q.reshape(B, KV, group, S, D).to(dt)
    s = torch.einsum("bkgsd,bktd->bkgst", qg, k.to(dt)) / math.sqrt(D)
    pos = torch.arange(S, device=q.device)
    s = s.masked_fill(~_mask(pos, pos, causal, window), NEG_INF)
    lse = torch.logsumexp(s, dim=-1)
    w = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgst,bktd->bkgsd", w, v.to(dt))
    return o.reshape(B, H, S, D).to(q.dtype), lse.reshape(B, H, S)


def attention_reference(q, k, v, *, causal: bool = True,
                        window: Optional[int] = None):
    """q: (B, H, S, D); k/v: (B, KV, S, D). Returns (B, H, S, D)."""
    return attention_forward_reference(q, k, v, causal=causal, window=window)[0]


def attention_backward_reference(q, k, v, o, lse, do, *, causal: bool = True,
                                 window: Optional[int] = None,
                                 chunk: int = 512):
    """The gradients of ``attention_reference`` from the forward's ``o`` and
    ``lse``, as ``_flash_bwd_padded``: delta = rowsum(do o),
    p = exp(s - lse), ds = p (dp - delta) / sqrt(D), dk and dv summed over
    the G query heads of each KV head. All in float32, over ``chunk`` query
    rows at a time (scores of (B, H, chunk, S) at most).

    q, o, do: (B, H, S, D); k, v: (B, KV, S, D); lse: (B, H, S) float32.
    Returns (dq, dk, dv) in q's, k's and v's dtypes."""
    B, H, S, D = q.shape
    KV = k.shape[1]
    G = H // KV
    scale = 1.0 / math.sqrt(D)
    grouped = lambda x: x.float().reshape(B, KV, G, S, D)
    qf, of, dof = grouped(q), grouped(o), grouped(do)
    kf, vf = k.float(), v.float()
    delta = (dof * of).sum(-1)                               # (B, KV, G, S)
    lse = lse.float().reshape(B, KV, G, S)
    dq = torch.empty_like(qf)
    dk = torch.zeros_like(kf)
    dv = torch.zeros_like(vf)
    kpos = torch.arange(S, device=q.device)
    for s0 in range(0, S, chunk):
        rows = slice(s0, min(S, s0 + chunk))
        qc, doc = qf[..., rows, :], dof[..., rows, :]
        s = torch.einsum("bkgsd,bktd->bkgst", qc, kf) * scale
        mask = _mask(kpos[rows], kpos, causal, window)
        p = torch.where(mask, torch.exp(s - lse[..., rows, None]), 0.0)
        dp = torch.einsum("bkgsd,bktd->bkgst", doc, vf)
        ds = p * (dp - delta[..., rows, None]) * scale
        dq[..., rows, :] = torch.einsum("bkgst,bktd->bkgsd", ds, kf)
        dk += torch.einsum("bkgst,bkgsd->bktd", ds, qc)
        dv += torch.einsum("bkgst,bkgsd->bktd", p, doc)
    return (dq.reshape(B, H, S, D).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))
