"""Pipeline parallelism: a GPipe-style microbatch schedule over a ``stage``
mesh axis, one rank per stage.

Counterpart of ``repro.distributed.pipeline``. The reference runs the loop
under ``shard_map`` with ``ppermute`` hops and a closing ``psum``; here each
rank of the stage group runs it for its own stage. The schedule is the
standard loop formulation: at step t, stage s processes microbatch (t - s);
activations hop one stage per step by a point-to-point send/recv on the
stage group; the bubble is (S-1) steps of (M+S-1). The last stage's outputs
reach every stage by an all-reduce (the others contribute zeros).

Gradients flow through the schedule: a hop is an autograd function whose
backward sends the gradient one stage back, and the closing all-reduce's
backward hands each rank the (replicated) output gradient as it stands.
Every rank computes its stage at every step and masks the inactive ones to
zero, as the reference, so all ranks run the same hops forwards and
backwards.
"""
from __future__ import annotations

from typing import Callable

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor


class _Hop(torch.autograd.Function):
    """y goes to the next stage; what the previous stage sent comes back."""

    @staticmethod
    def forward(ctx, y, group, nxt: int, prv: int):
        ctx.group, ctx.nxt, ctx.prv = group, nxt, prv
        return _exchange(y, group, to=nxt, frm=prv)

    @staticmethod
    def backward(ctx, g):
        return _exchange(g.contiguous(), ctx.group, to=ctx.prv,
                         frm=ctx.nxt), None, None, None


def _exchange(y: torch.Tensor, group, to: int, frm: int) -> torch.Tensor:
    y = y.contiguous()
    buf = torch.empty_like(y)
    reqs = dist.batch_isend_irecv([
        dist.P2POp(dist.isend, y, dist.get_global_rank(group, to), group),
        dist.P2POp(dist.irecv, buf, dist.get_global_rank(group, frm), group)])
    for r in reqs:
        r.wait()
    return buf


class _Broadcast(torch.autograd.Function):
    """Sum over the stage group; the gradient, already the same on every
    rank, passes back as it is."""

    @staticmethod
    def forward(ctx, x, group):
        out = x.clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        return g, None


def pipeline_forward(stage_fn: Callable, n_stages: int, n_micro: int,
                     mesh, stage_axis: str = "stage"):
    """Build fn(stage_params, x_micro) -> y_micro on this rank's stage.

    stage_fn(params_for_stage, x) -> y is the per-stage computation (y
    shaped as x). stage_params (a tensor or a dict of them) have leading
    dim n_stages (whole, or ``DTensor``s sharded over the stage axis);
    x_micro is (n_micro, mb, ...), the same on every rank. Returns y_micro,
    the same on every rank."""
    group = mesh.get_group(stage_axis)
    S, M = n_stages, n_micro
    if dist.get_world_size(group) != S:
        raise ValueError(f"stage axis has {dist.get_world_size(group)} "
                         f"ranks, not {S}")

    def fn(params, x_micro):
        sid = dist.get_rank(group)
        mine = lambda v: v.to_local()[0] if isinstance(v, DTensor) else v[sid]
        params = ({k: mine(v) for k, v in params.items()}
                  if isinstance(params, dict) else mine(params))
        T = M + S - 1
        buf = torch.zeros_like(x_micro[0])
        ys = []
        for t in range(T):
            mb = t - sid
            # stage 0 reads fresh input; the others the handed-off buffer
            x_in = buf if sid else x_micro[min(max(mb, 0), M - 1)] + 0 * buf
            y = stage_fn(params, x_in)
            ys.append(y if 0 <= mb < M else y * 0)
            buf = _Hop.apply(ys[-1], group, (sid + 1) % S, (sid - 1) % S)
        # the last stage ran microbatch m at step m + S - 1. Every step's y
        # stays on every rank's graph (times 0 where it is not an output),
        # so every rank runs the same hops backwards, in the same order
        out = torch.stack(ys[sid:sid + M]) * float(sid == S - 1)
        out = out + 0 * torch.stack([y.sum() for y in ys]).sum()
        return _Broadcast.apply(out, group)

    return fn


def make_pp_mesh(n_stages: int, n_data: int = 1, device_type: str = "cuda"):
    """A (stage, data) ``DeviceMesh`` over the initialised process group."""
    from torch.distributed.device_mesh import init_device_mesh
    return init_device_mesh(device_type, (n_stages, n_data),
                            mesh_dim_names=("stage", "data"))
