"""Mamba2 (SSD) block for the Zamba2 hybrid backbone.

Counterpart of ``repro.models.mamba``. Projections are stored head-major,
in_x/in_z (D, H, P) and out_proj (H, P, D), as the reference's; the B/C
projections (n_groups * d_state) are shared across heads.

split projections -> depthwise causal conv over (x, B, C) -> selective
state-space recurrence with per-head scalar decay
``a_t = exp(-exp(A_log) * dt_t)`` through the generalized GLA scan (mode
``ssd``) -> gated RMSNorm over (H, P) -> out projection.

Prefill scans from a zero state: with ``impl == "kernel"`` through the
``gla_scan`` CUDA kernel (its plain version on CPU tensors), with
``"einsum"`` through the plain chunked scan ``gla_chunked``. Decode is the
single-token ``gla_step`` (the reference has no kernel for it). Training
(``mode="train"``) takes ``gla_chunked`` whatever ``impl`` says, as the
reference does: no scan kernel has a backward. The depthwise
conv keeps the reference's summation order and dtype; ``dt``, the decay and
the norm compute in float32.

Decode state per layer: conv_x (B, K-1, H, P), conv_bc (B, K-1, 2GN), ssm
state (B, H, N, P) float32.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed.axes import constrain, contract_whole, on_local
# the package, not its function: the kernel's plain version imports
# models.linear_attention, so a name bound here at import would be circular
from repro_torch.kernels import gla_scan as gla_kernel
from repro_torch.models.layers import (as_param, project_heads,
                                       truncated_normal_init)
from repro_torch.models.linear_attention import (gla_chunked,
                                                 gla_chunked_sharded, gla_step)

IMPLS = ("kernel", "einsum", "auto")


class MambaParams(nn.Module):
    """One Mamba2 layer in the reference's names and shapes
    (``repro.models.mamba.mamba_block_params``)."""

    MATRICES = ("in_z", "in_x", "in_B", "in_C", "in_dt", "out_proj")

    def __init__(self, **tensors: torch.Tensor):
        super().__init__()
        for name, t in tensors.items():
            setattr(self, name, as_param(t))


def mamba_block_params(cfg: ModelConfig, generator: torch.Generator,
                       device: torch.device, dtype: torch.dtype) -> MambaParams:
    """Random projections with the reference's scales, in ``dtype``; the
    conv weights are float32 draws, and A_log and dt_bias the reference's
    deterministic values."""
    d, s = cfg.d_model, cfg.ssm
    H = s.n_heads(d)
    G, N, P = s.n_groups, s.d_state, s.head_dim
    sc = 1.0 / math.sqrt(d)
    tn = lambda shape, scale: truncated_normal_init(shape, scale, generator,
                                                    device, dtype)
    f32 = dict(dtype=torch.float32, device=device)
    normal = lambda *shape: 0.1 * torch.randn(shape, generator=generator, **f32)
    # standard Mamba init: dt in [1e-3, 1e-1] log-uniform, via softplus^-1
    lo, hi = torch.log(torch.tensor([1e-3, 1e-1], dtype=torch.float32)).tolist()
    dt = torch.exp(torch.linspace(lo, hi, H, **f32))
    return MambaParams(
        in_z=tn((d, H, P), sc), in_x=tn((d, H, P), sc),
        in_B=tn((d, G * N), sc), in_C=tn((d, G * N), sc), in_dt=tn((d, H), sc),
        conv_x_w=normal(s.d_conv, H, P), conv_x_b=torch.zeros(H, P, **f32),
        conv_bc_w=normal(s.d_conv, 2 * G * N),
        conv_bc_b=torch.zeros(2 * G * N, **f32),
        A_log=torch.log(torch.linspace(1.0, 16.0, H, **f32)),
        dt_bias=torch.log(torch.expm1(dt)),
        D_skip=torch.ones(H, **f32), norm_scale=torch.ones(H, P, **f32),
        out_proj=tn((H, P, d), 1.0 / math.sqrt(H * P)))


def _causal_conv(x, w, b, conv_state: Optional[torch.Tensor]):
    """Depthwise causal conv along time. x: (B,T,...C); w: (K,...C).
    Summed tap by tap in x's dtype, as the reference's
    ``sum(xp[:, k:k+T] * w[k])``."""
    K, T = w.shape[0], x.shape[1]
    if conv_state is None:
        xp = torch.cat([x.new_zeros((x.shape[0], K - 1) + x.shape[2:]), x], dim=1)
    else:
        xp = torch.cat([conv_state.to(x.dtype), x], dim=1)
    w = w.to(x.dtype)
    y = xp[:, 0:T] * w[0]
    for k in range(1, K):
        y = y + xp[:, k:k + T] * w[k]
    y = y + b.to(x.dtype)
    new_state = xp[:, xp.shape[1] - (K - 1):]
    return F.silu(y), new_state


def _gated_norm(o, z, scale):
    """RMSNorm of o * silu(z) over the full inner dim (H*P), in float32."""
    g = o.float() * F.silu(z.float())
    var = torch.mean(torch.square(g), dim=(-2, -1), keepdim=True)
    return g * torch.rsqrt(var + 1e-5) * scale


def mamba_block(x, p: MambaParams, cfg: ModelConfig, *, conv_state=None,
                ssm_state=None, mode: str = "prefill", impl: str = "kernel"):
    """x: (B,T,D) -> (out, (new_conv_x, new_conv_bc), new_ssm_state).

    conv_state: None (zeros) or (conv_x_state, conv_bc_state); ssm_state:
    None (zeros) or (B,H,N,P) float32. Decode (T = 1) reads both; prefill
    with ``impl == "kernel"`` scans from zero and refuses a state."""
    if impl not in IMPLS:
        raise ValueError(f"unknown impl {impl!r}")
    s = cfg.ssm
    H = s.n_heads(cfg.d_model)
    G, N = s.n_groups, s.d_state
    B_, T, _ = x.shape
    # whole sequences: the conv and the scan run along them
    x = constrain(x, ("batch", "seq_inner", "embed"))

    z = project_heads(x, p.in_z)
    xs = constrain(project_heads(x, p.in_x), ("batch", "seq", "heads", "head_dim"))
    Bmat = x @ p.in_B.to(x.dtype)
    Cmat = x @ p.in_C.to(x.dtype)
    dt = x @ p.in_dt.to(x.dtype)                                     # (B,T,H)

    cx, cbc = conv_state if conv_state is not None else (None, None)
    xs, new_cx = _causal_conv(xs, p.conv_x_w, p.conv_x_b, cx)
    bc, new_cbc = _causal_conv(torch.cat([Bmat, Cmat], -1), p.conv_bc_w,
                               p.conv_bc_b, cbc)
    Bmat, Cmat = bc.chunk(2, dim=-1)

    dt = F.softplus(dt.float() + p.dt_bias)                          # (B,T,H)
    log_w = -torch.exp(p.A_log) * dt                                 # (B,T,H)

    xs = xs * dt.to(xs.dtype)[..., None]                             # dt-scaled
    rep = H // G
    Bm = torch.repeat_interleave(Bmat.reshape(B_, T, G, N), rep, dim=2)  # (B,T,H,N)
    Cm = torch.repeat_interleave(Cmat.reshape(B_, T, G, N), rep, dim=2)
    log_w_full = log_w[..., None].expand(B_, T, H, N)

    if mode == "decode":
        o, ssm_state = gla_step(Cm[:, 0], Bm[:, 0], xs[:, 0], log_w_full[:, 0],
                                ssm_state, mode="ssd")
        o = o[:, None]
    elif impl == "kernel" and mode != "train":
        if ssm_state is not None:
            raise ValueError("the gla_scan kernel scans from a zero state")
        # the kernel reads log_w as a dense (B,T,H,N) tensor: materialise
        # the broadcast over N
        o, ssm_state = gla_kernel.gla_scan(
            Cm.contiguous(), Bm.contiguous(), xs.contiguous(),
            log_w_full.contiguous(), mode="ssd")
    elif ssm_state is None:
        o, ssm_state = gla_chunked_sharded(Cm, Bm, xs, log_w_full, mode="ssd")
    else:
        o, ssm_state = gla_chunked(Cm, Bm, xs, log_w_full, mode="ssd",
                                   initial_state=ssm_state)
    o = o + xs * p.D_skip.to(xs.dtype)[None, None, :, None]

    # gated RMSNorm over the full inner dim (H*P), head-major layout
    g = on_local(_gated_norm, o, z, p.norm_scale, keep=(0, 1), whole=(2,))
    out = contract_whole(lambda g, w: g.flatten(2) @ w.flatten(0, 1),
                         g.to(x.dtype), p.out_proj, dims=(0, 1))
    return out, (new_cx, new_cbc), ssm_state


def mamba_state_shapes(cfg: ModelConfig, batch: int) -> Dict[str, Tuple[int, ...]]:
    s = cfg.ssm
    H = s.n_heads(cfg.d_model)
    return {
        "conv_x": (cfg.n_layers, batch, s.d_conv - 1, H, s.head_dim),
        "conv_bc": (cfg.n_layers, batch, s.d_conv - 1, 2 * s.n_groups * s.d_state),
        "ssm": (cfg.n_layers, batch, H, s.d_state, s.head_dim),
    }
