"""Mixture-of-Experts with sort-based capacity dispatch.

Counterpart of ``repro.models.moe``, with its semantics kept exactly:
capacity is per batch row, C = max(8, roundup8(ceil(top_k * S * cf / E)));
each row's (token, k) assignments are sorted by expert with a stable sort
and the first C of each expert are kept, the rest dropped; gates are
renormalised over the top-k; the Switch aux loss is computed (and ignored
when serving). The reference vmaps its dispatch over rows; here every step
is batched over B directly.

Two deliberate differences of form, neither of value:

  - top-k is a stable descending sort, so equal router probabilities pick
    the lower expert first, as ``jax.lax.top_k`` does (``torch.topk`` on
    CUDA promises no order among ties, and bf16 router logits tie often);
  - the dispatch buffer and the combine are gathers, not scatters: each
    (token, k) pair has exactly one place in the sorted order, so the
    combine inverts the permutation, gathers (B, S, K, D) and sums over K
    in float32. The reference's ``.at[token].add`` would be ``index_add_``
    here, whose float32 atomics change with each run on the card.

At decode (one token per row) C = 8, so every expert computes 8 capacity
slots per row: the reference's static-shape semantics, kept.
"""
from __future__ import annotations

import math
from types import SimpleNamespace
from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import MoEConfig
from repro_torch.distributed.axes import (constrain, contract_whole, on_local,
                                          split_over)
from repro_torch.models.layers import (activation, as_param, dense_init,
                                       truncated_normal_init)


class MoEParams(nn.Module):
    """router (D, E), up/gate (E, D, F), down (E, F, D), in the compute
    dtype."""

    def __init__(self, router, up, gate, down):
        super().__init__()
        self.router, self.up, self.gate, self.down = (
            as_param(w) for w in (router, up, gate, down))


def moe_params(d_model: int, cfg: MoEConfig, generator, device,
               dtype=torch.float32) -> MoEParams:
    """The reference's initializers and scales. Each expert's matrix is
    drawn on its own, so no float32 copy of a whole (E, D, F) tensor is
    ever held."""
    E, Fd = cfg.n_experts, cfg.d_expert

    def experts(shape, scale):
        out = torch.empty((E,) + shape, dtype=dtype, device=device)
        for e in range(E):
            out[e] = truncated_normal_init(shape, scale, generator, device, dtype)
        return out

    router = dense_init(d_model, E, generator, device, dtype)
    up = experts((d_model, Fd), 1.0 / math.sqrt(d_model))
    gate = experts((d_model, Fd), 1.0 / math.sqrt(d_model))
    down = experts((Fd, d_model), 1.0 / math.sqrt(Fd))
    return MoEParams(router, up, gate, down)


def capacity_for(tokens_per_row: int, cfg: MoEConfig,
                 capacity_factor: float = 1.25) -> int:
    c = int(math.ceil(cfg.top_k * tokens_per_row * capacity_factor
                      / cfg.n_experts))
    return max(8, -(-c // 8) * 8)  # a multiple of 8, as the reference's


def route(x: torch.Tensor, p: MoEParams, cfg: MoEConfig):
    """Router probabilities (B, S, E) float32 and the renormalised top-k
    gates and experts (B, S, K), ties to the lower expert. Reads only
    ``p.router``."""
    logits = (x @ p.router.to(x.dtype)).float()
    probs = torch.softmax(logits, dim=-1)
    top, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gates, idx = top[..., :cfg.top_k], idx[..., :cfg.top_k]
    gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)
    return probs, gates, idx


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


def _dispatch_rows(x: torch.Tensor, idx: torch.Tensor, E: int, C: int):
    """Each row's capacity buffer (B, E, C, D) of the tokens its experts
    ``idx`` (B, S, K) keep, and where each (token, k) assignment's output
    lies in it: ``slot`` (B, S*K) and ``kept`` (B, S*K)."""
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
    return buf, torch.gather(dest, 1, inv), torch.gather(keep, 1, inv)


def _combine_rows(out_buf: torch.Tensor, slot: torch.Tensor,
                  kept: torch.Tensor, gates: torch.Tensor) -> torch.Tensor:
    """(B, S, D) float32: each token's kept expert outputs, gate-weighted,
    summed over its K choices."""
    B, E, C, D = out_buf.shape
    S, K = gates.shape[1], gates.shape[2]
    picked = torch.gather(out_buf.reshape(B, E * C, D), 1,
                          slot.clamp(max=E * C - 1)[..., None].expand(B, S * K, D))
    picked = torch.where(kept[..., None], picked.float(), 0.0)
    return (picked.reshape(B, S, K, D) * gates[..., None]).sum(dim=2)


def apply_moe(x: torch.Tensor, p: MoEParams, cfg: MoEConfig, act: str = "silu",
              capacity_factor: float = 1.25) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, D) -> (out (B, S, D), aux_loss scalar).

    Routing, dispatch and combine treat each batch row on its own: under a
    mesh they run on each rank's rows (``on_local``); the expert products
    run on the dispatch buffer sharded over experts (EP) or over d_expert."""
    B, S, D = x.shape
    E, K = cfg.n_experts, cfg.top_k
    C = capacity_for(S, cfg, capacity_factor)
    probs, gates, idx = on_local(
        lambda x, w: route(x, SimpleNamespace(router=w), cfg), x, p.router,
        whole=(1,))

    # aux load-balancing loss (Switch-style), over all tokens
    me = probs.mean(dim=(0, 1))
    ce = on_local(lambda i: F.one_hot(i[..., 0], E).float(), idx).mean(dim=(0, 1))
    aux = cfg.aux_loss_coef * E * torch.sum(me * ce)

    buf, slot, kept = on_local(lambda x, i: _dispatch_rows(x, i, E, C), x, idx)
    buf = constrain(buf, ("batch", "expert", None, None))
    up = torch.einsum("becd,edf->becf", buf, p.up.to(x.dtype))
    gt = torch.einsum("becd,edf->becf", buf, p.gate.to(x.dtype))
    h = activation(gt, act) * up
    # experts split along d_expert (no expert parallelism): h is gathered
    # along it, and a DTensor einsum's view of the strided gather fails
    # where a broadcast matmul's reshape copies
    product = ((lambda h, w: h @ w[None]) if split_over(p.down, (1,)) else
               (lambda h, w: torch.einsum("becf,efd->becd", h, w)))
    out_buf = contract_whole(product, h, p.down, dims=(1,))
    out_buf = constrain(out_buf, ("batch", "expert", None, None))
    out = on_local(_combine_rows, out_buf, slot, kept, gates)
    return out.to(x.dtype), aux
