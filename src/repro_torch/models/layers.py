"""Shared layer primitives: norms, rotary embeddings, MLP, initializers.

Counterpart of ``repro.models.layers``. Parameters live in small
``nn.Module`` containers and the math is plain functions on tensors, so each
function here maps one for one onto its reference. Norms compute in float32
and cast back, as the reference does. The containers hold their tensors with
``requires_grad=False``: serving never builds a graph, and training
(``repro_torch.train.trainer``) differentiates with respect to tensors of its
own, put in place of these by ``torch.func.functional_call``.
"""
from __future__ import annotations

import functools
import math
from typing import Callable, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch.distributed.axes import contract_whole, on_local, whole_along


def as_param(t: torch.Tensor) -> nn.Parameter:
    return nn.Parameter(t, requires_grad=False)


def truncated_normal_init(shape: Sequence[int], scale: float,
                          generator: torch.Generator, device: torch.device,
                          dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """``scale`` x a unit normal truncated at two sigma, drawn in float32 and
    stored in ``dtype``. Same distribution as the reference's
    ``jax.random.truncated_normal(-2, 2)``; not the same numbers."""
    t = torch.empty(tuple(shape), dtype=torch.float32, device=device)
    nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=generator)
    return t.mul_(scale).to(dtype)


def dense_init(d_in: int, d_out: int, generator, device, dtype=torch.float32):
    return truncated_normal_init((d_in, d_out), 1.0 / math.sqrt(d_in),
                                 generator, device, dtype)


def embed_init(vocab: int, d: int, generator, device, dtype=torch.float32):
    return truncated_normal_init((vocab, d), 1.0, generator, device, dtype)


def project_heads(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """einsum("...d,dhk->...hk") as one matrix product: x (..., D) @ w
    (D, H, K), in x's dtype. Under a mesh a split K is gathered first: the
    flattened (H, K) can stay split along H only."""
    w = whole_along(w.to(x.dtype), (2,))
    return (x @ w.flatten(1)).unflatten(-1, w.shape[1:])


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------

class NormParams(nn.Module):
    """RMSNorm scale, plus a bias for LayerNorm; always float32."""

    def __init__(self, scale: torch.Tensor, bias: Optional[torch.Tensor] = None):
        super().__init__()
        self.scale = as_param(scale.float())
        self.bias = as_param(bias.float()) if bias is not None else None


def norm_params(d: int, kind: str, device) -> NormParams:
    ones = torch.ones(d, dtype=torch.float32, device=device)
    return NormParams(ones, torch.zeros_like(ones) if kind == "layernorm" else None)


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """x * rsqrt(mean(x^2) + eps) * scale, computed in float32; under a mesh
    on each rank's rows (however its batch and sequence are split)."""
    return on_local(lambda x, s: F.rms_norm(x.float(), (x.shape[-1],),
                                            s.float(), eps).to(x.dtype),
                    x, scale, keep=(0, 1), whole=(1,))


def layernorm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
              eps: float = 1e-5) -> torch.Tensor:
    """(x - mean) * rsqrt(var + eps) * scale + bias, computed in float32;
    under a mesh on each rank's rows."""
    return on_local(lambda x, s, b: F.layer_norm(x.float(), (x.shape[-1],),
                                                 s.float(), b.float(),
                                                 eps).to(x.dtype),
                    x, scale, bias, keep=(0, 1), whole=(1, 2))


def apply_norm(x: torch.Tensor, p: NormParams, kind: str, eps: float):
    if kind == "rmsnorm":
        return rmsnorm(x, p.scale, eps)
    return layernorm(x, p.scale, p.bias, eps)


# ---------------------------------------------------------------------------
# Activations
# ---------------------------------------------------------------------------

def activation(x: torch.Tensor, kind: str) -> torch.Tensor:
    if kind == "silu":
        return F.silu(x)
    if kind == "gelu":  # jax.nn.gelu defaults to the tanh approximation
        return F.gelu(x, approximate="tanh")
    if kind == "relu_sq":  # RWKV channel-mix
        return torch.square(F.relu(x))
    raise ValueError(f"unknown activation {kind}")


# ---------------------------------------------------------------------------
# Rotary embeddings (RoPE / partial RoPE / M-RoPE)
# ---------------------------------------------------------------------------

def rope_freqs(head_dim: int, rope_pct: float, theta: float,
               device: Optional[torch.device] = None) -> torch.Tensor:
    rot = int(head_dim * rope_pct) // 2 * 2
    exps = torch.arange(0, rot, 2, dtype=torch.float32, device=device) / rot
    return 1.0 / torch.pow(torch.tensor(theta, dtype=torch.float32,
                                        device=device), exps)  # (rot/2,)


def rope_angles(positions: torch.Tensor, head_dim: int, rope_pct: float,
                theta: float, mrope: bool = False) -> torch.Tensor:
    """Unit complex rotations exp(i * pos * inv_freq), (..., S, 1, rot/2).

    ``mrope``: ``positions`` are M-RoPE's (B, S, 3) streams (t, h, w) and
    every frequency of the whole head takes the stream of its section
    (``MROPE_SECTIONS``), so the angles are per (B, S, head_dim/2). Text
    positions (three equal streams) give plain RoPE's angles bit for bit.
    Computed once per forward and shared by every layer's q and k."""
    if mrope:
        inv = rope_freqs(head_dim, 1.0, theta, positions.device)
        pos = positions.float()[..., mrope_streams(head_dim, positions.device)]
    else:
        inv = rope_freqs(head_dim, rope_pct, theta, positions.device)
        pos = positions[..., :, None].float()            # (..., S, 1)
    ang = pos * inv                                      # (..., S, rot/2)
    return torch.polar(torch.ones_like(ang), ang)[..., :, None, :]


def apply_rope(x: torch.Tensor, rot: torch.Tensor) -> torch.Tensor:
    """x: (..., S, H, D); rot: ``rope_angles`` for x's positions.

    Rotates the interleaved pairs (x[2j], x[2j+1]) of the first 2*rot/2
    channels in float32, as the reference's
    (x1 cos - x2 sin, x2 cos + x1 sin), and leaves the rest (partial RoPE)."""
    n = 2 * rot.shape[-1]
    xr = x[..., :n].float().unflatten(-1, (n // 2, 2))
    out = torch.view_as_real(torch.view_as_complex(xr) * rot).flatten(-2)
    out = out.to(x.dtype)
    return torch.cat([out, x[..., n:]], dim=-1) if n < x.shape[-1] else out


# M-RoPE (Qwen2-VL): the head's frequencies split into 3 sections (t, h, w),
# each rotated with its own position stream. For text tokens all three
# position ids coincide and M-RoPE reduces to RoPE.
MROPE_SECTIONS = (0.25, 0.375, 0.375)


def mrope_streams(head_dim: int, device=None) -> torch.Tensor:
    """(head_dim/2,) index of the position stream each frequency takes."""
    half = head_dim // 2
    sec = [int(half * s) for s in MROPE_SECTIONS[:2]]
    sec.append(half - sec[0] - sec[1])
    return torch.tensor([i for i, n in enumerate(sec) for _ in range(n)],
                        device=device)


def apply_mrope(x: torch.Tensor, positions3: torch.Tensor,
                theta: float) -> torch.Tensor:
    """x: (B, S, H, D); positions3: (B, S, 3) multimodal position ids."""
    return apply_rope(x, rope_angles(positions3, x.shape[-1], 1.0, theta,
                                     mrope=True))


# ---------------------------------------------------------------------------
# MLP
# ---------------------------------------------------------------------------

class MLPParams(nn.Module):
    """up/gate (D, F) and down (F, D), stored in the compute dtype."""

    def __init__(self, up, down, gate=None):
        super().__init__()
        self.up = as_param(up)
        self.down = as_param(down)
        self.gate = as_param(gate) if gate is not None else None


def mlp_params(d: int, d_ff: int, gated: bool, generator, device,
               dtype=torch.float32) -> MLPParams:
    up = dense_init(d, d_ff, generator, device, dtype)
    down = dense_init(d_ff, d, generator, device, dtype)
    gate = dense_init(d, d_ff, generator, device, dtype) if gated else None
    return MLPParams(up, down, gate)


def apply_mlp(x: torch.Tensor, p: MLPParams, act: str, gated: bool) -> torch.Tensor:
    up = x @ p.up.to(x.dtype)
    if gated:
        h = activation(x @ p.gate.to(x.dtype), act) * up
    else:
        h = activation(up, act)
    return contract_whole(torch.matmul, h, p.down)


# ---------------------------------------------------------------------------
# Rematerialisation (training)
# ---------------------------------------------------------------------------

REMAT_POLICIES = ("minimal", "dots")
# matrix products without batch dimensions: ``x @ W`` with W 2-D reaches
# autograd as ``aten.mm`` (``addmm`` with a bias); einsums over heads or
# experts are ``bmm`` and are recomputed
_SAVED_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _dots_policy(ctx, op, *args, **kwargs):
    return (CheckpointPolicy.MUST_SAVE if op in _SAVED_DOTS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def rematerialized(fn: Callable, policy: str) -> Callable:
    """``fn`` under ``torch.utils.checkpoint``, the counterpart of the
    reference's ``jax.checkpoint`` of a layer: ``"minimal"`` saves nothing
    of its inside (its inputs only), ``"dots"`` also saves the outputs of
    matrix products without batch dimensions, as
    ``jax.checkpoint_policies.dots_with_no_batch_dims_saveable``."""
    if policy not in REMAT_POLICIES:
        raise ValueError(f"unknown remat policy {policy!r}")
    kw = {}
    if policy == "dots":
        kw["context_fn"] = functools.partial(
            create_selective_checkpoint_contexts, _dots_policy)
    return lambda *args: checkpoint(fn, *args, use_reentrant=False, **kw)
