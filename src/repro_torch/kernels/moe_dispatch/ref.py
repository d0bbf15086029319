"""Plain PyTorch versions of the MoE dispatch and combine kernels.

The capacity dispatch of ``repro.models.moe`` (``_dispatch_row``,
``_combine_row``), batched over rows, as gathers: each (token, k)
assignment has exactly one place in the stable sort by expert, so the
buffer gathers its rows and the combine inverts the permutation. The
wrapper (``ops.py``) runs these for CPU tensors; the tests and
``chip_ab.py`` hold the kernels against them.
"""
from __future__ import annotations

import torch


def dispatch(idx: torch.Tensor, E: int, C: int):
    """Per-row capacity dispatch of the experts ``idx`` (B, S, K).

    Returns, in the sorted order of each row's S*K assignments (a stable
    sort by expert): ``order`` (the flat s*K + k of each), ``keep`` (within
    its expert's first C) and ``dest`` (its slot e*C + position, or E*C
    when dropped), and each expert's ``group_start`` and ``group_size``
    (B, E). The reference's ``_dispatch_row`` metadata, batched."""
    B, S, K = idx.shape
    flat = idx.reshape(B, S * K)
    order = torch.argsort(flat, dim=-1, stable=True)
    sorted_expert = torch.gather(flat, 1, order)
    size = torch.zeros((B, E), dtype=torch.long, device=idx.device)
    size.scatter_add_(1, flat, torch.ones_like(flat))
    start = torch.cumsum(size, dim=1) - size
    pos = torch.arange(S * K, device=idx.device) - torch.gather(start, 1, sorted_expert)
    keep = pos < C
    dest = torch.where(keep, sorted_expert * C + pos, E * C)
    return order, keep, dest, start, size


def moe_dispatch_reference(x: torch.Tensor, idx: torch.Tensor, E: int, C: int):
    """Each row's capacity buffer (B, E, C, D) of the tokens its experts
    ``idx`` (B, S, K) keep, where each (token, k) assignment's output lies
    in it: ``slot`` (B, S*K) and ``kept`` (B, S*K), and each expert's
    assignments in each row, ``size`` (B, E)."""
    B, S, D = x.shape
    K = idx.shape[-1]
    order, keep, dest, start, size = dispatch(idx, E, C)
    # slot (e, c) holds the assignment at sorted place start[e] + c when
    # c < size[e], else zeros: a gather, one source per slot
    c_idx = torch.arange(C, device=x.device)
    src = (start[:, :, None] + c_idx).reshape(B, E * C).clamp(max=S * K - 1)
    token = torch.gather(order, 1, src) // K                       # (B, E*C)
    filled = (c_idx < size[:, :, None]).reshape(B, E * C, 1)
    buf = torch.gather(x, 1, token[..., None].expand(B, E * C, D))
    buf = torch.where(filled, buf, 0).reshape(B, E, C, D)
    # combine: assignment s*K + k sits at sorted place inv[s*K + k]
    inv = torch.empty_like(order).scatter_(
        1, order, torch.arange(S * K, device=x.device).expand(B, S * K))
    return buf, torch.gather(dest, 1, inv), torch.gather(keep, 1, inv), size


def moe_combine_reference(out_buf: torch.Tensor, slot: torch.Tensor,
                          kept: torch.Tensor, gates: torch.Tensor) -> torch.Tensor:
    """(B, S, D) float32: each token's kept expert outputs, gate-weighted,
    summed over its K choices."""
    B, E, C, D = out_buf.shape
    S, K = gates.shape[1], gates.shape[2]
    picked = torch.gather(out_buf.reshape(B, E * C, D), 1,
                          slot.clamp(max=E * C - 1)[..., None].expand(B, S * K, D))
    picked = torch.where(kept[..., None], picked.float(), 0.0)
    return (picked.reshape(B, S, K, D) * gates[..., None]).sum(dim=2)


def moe_combine_grad_reference(grad_out: torch.Tensor, out_buf: torch.Tensor,
                               slot: torch.Tensor, kept: torch.Tensor,
                               gates: torch.Tensor):
    """The combine's gradients, written out: (grad of ``out_buf`` in its
    dtype, grad of ``gates`` float32). Each kept slot holds its gate times
    its token's output gradient, every other slot zeros (a dispatch of the
    scaled gradient); each kept gate's gradient is the dot product of its
    slot's row with that gradient, a dropped one's zero."""
    B, E, C, D = out_buf.shape
    S, K = gates.shape[1], gates.shape[2]
    go = grad_out.float()[:, :, None, :]                            # (B, S, 1, D)
    rows = (go * gates[..., None]).reshape(B, S * K, D)
    dest = torch.where(kept, slot, E * C)        # dropped rows into a spare slot
    grad_buf = torch.zeros((B, E * C + 1, D), dtype=torch.float32,
                           device=out_buf.device)
    grad_buf.scatter_(1, dest[..., None].expand(B, S * K, D), rows)
    grad_buf = grad_buf[:, :E * C].reshape(B, E, C, D).to(out_buf.dtype)
    picked = torch.gather(out_buf.reshape(B, E * C, D), 1,
                          slot.clamp(max=E * C - 1)[..., None].expand(B, S * K, D))
    picked = torch.where(kept[..., None], picked.float(), 0.0)
    return grad_buf, (picked.reshape(B, S, K, D) * go).sum(dim=-1)
