"""Train-step factory: loss and gradients by autograd, then AdamW, with
optional microbatch gradient accumulation.

Counterpart of ``repro.train.trainer``. ``params`` is a dict of named
tensors, the float32 masters (``param_dict(model.init(seed, device,
dtype=torch.float32))``), and the step is pure, as the reference's: it
returns new parameters and optimizer state and leaves its inputs as they
were, so a runner can reject an update. The model's functions read their
parameters from a module tree; ``torch.func.functional_call`` puts the
dict's tensors into a structure-only (``meta``) tree for the forward and its
backward, recomputation under remat included, and autograd differentiates
with respect to them.
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch
from torch import nn
from torch.func import functional_call

from repro_torch.distributed.axes import for_compute, like, to_plain
from repro_torch.models.lm import Model
from repro_torch.train.optimizer import AdamWConfig, adamw_update

Tree = Dict[str, torch.Tensor]


def param_dict(tree: nn.Module) -> Tree:
    """The module tree's tensors by ``named_parameters()`` name."""
    return {name: p.detach() for name, p in tree.named_parameters()}


def batch_to(batch: Dict, device) -> Dict[str, torch.Tensor]:
    """A batch of numpy arrays (``SyntheticLM``'s) or tensors on ``device``;
    integer arrays (token ids, labels, positions) become int64."""
    out = {}
    for key, x in batch.items():
        t = torch.from_numpy(np.asarray(x)) if not isinstance(x, torch.Tensor) else x
        if not (t.is_floating_point() or t.dtype == torch.bool):
            t = t.long()
        out[key] = t.to(device)
    return out


class _Objective(nn.Module):
    """The loss and its gradients with respect to ``wrt``; called through
    ``functional_call``, so that ``tree``'s parameters are the tensors of
    ``wrt`` for the forward and the backward alike."""

    def __init__(self, model: Model, tree: nn.Module):
        super().__init__()
        self.model = model
        self.tree = tree

    def forward(self, batch, wrt: List[torch.Tensor]):
        loss, metrics = self.model.loss_fn(self.tree, batch)
        grads = torch.autograd.grad(loss, wrt, allow_unused=True)
        return loss.detach(), {k: v.detach() for k, v in metrics.items()}, grads


def make_value_and_grad(model: Model):
    """Returns value_and_grad(params, batch) -> (loss, metrics, grads) of
    ``model.loss_fn``, grads a dict like ``params``; batch as tensors on
    the parameters' device (``batch_to``)."""
    objective = _Objective(model, model.init(0, device="meta",
                                             dtype=torch.float32))

    def value_and_grad(params: Tree, batch):
        wrt = {name: p.detach().requires_grad_() for name, p in params.items()}
        with torch.enable_grad():
            # DTensor masters: their shards over the batch axes are gathered
            # for the forward (FSDP); the gradients come back to the
            # masters' placements through the gathers' backward
            used = {k: for_compute(v) for k, v in wrt.items()}
            loss, metrics, grads = functional_call(
                objective, {f"tree.{k}": v for k, v in used.items()},
                (batch, list(wrt.values())), strict=True)
        # a parameter the loss does not read (HuBERT's embedding) gets 0
        grads = {name: torch.zeros_like(p) if g is None else like(g, p)
                 for (name, p), g in zip(params.items(), grads)}
        return (to_plain(loss), {k: to_plain(v) for k, v in metrics.items()},
                grads)

    return value_and_grad


def accumulated(value_and_grad, params: Tree, batch: Dict, grad_accum: int):
    """(loss, metrics, grads) of ``batch`` (tensors) in ``grad_accum``
    microbatches run one after the other: microbatch m takes rows {m, ga+m,
    2ga+m, ...}, as the reference's strided split; gradients add up in
    float32 and are divided by grad_accum, the loss is the microbatches'
    mean and ``aux`` is reported as 0, as the reference does."""
    if grad_accum == 1:
        return value_and_grad(params, batch)
    rows = next(iter(batch.values())).shape[0]
    if rows % grad_accum:
        raise ValueError(f"batch of {rows} rows does not split into "
                         f"{grad_accum} microbatches")
    # laid out as the parameters (a DTensor's gradients are DTensors)
    grads = {name: torch.zeros_like(p, dtype=torch.float32)
             for name, p in params.items()}
    losses = []
    for m in range(grad_accum):
        micro = {k: v[m::grad_accum] for k, v in batch.items()}
        loss_m, _, g = value_and_grad(params, micro)
        for name in grads:
            grads[name] += g[name].float()
        losses.append(loss_m)
    loss = torch.stack(losses).mean()
    return (loss, {"ce": loss, "aux": torch.zeros((), device=loss.device)},
            {name: g / grad_accum for name, g in grads.items()})


def make_train_step(model: Model, opt_cfg: AdamWConfig, grad_accum: int = 1):
    """Returns train_step(params, opt_state, batch) -> (params, opt, metrics),
    accumulating gradients over ``grad_accum`` microbatches
    (``accumulated``)."""
    value_and_grad = make_value_and_grad(model)

    def train_step(params: Tree, opt_state: Dict, batch: Dict):
        batch = batch_to(batch, next(iter(params.values())).device)
        loss, metrics, grads = accumulated(value_and_grad, params, batch,
                                           grad_accum)
        new_params, new_opt, opt_metrics = adamw_update(opt_cfg, grads,
                                                        opt_state, params)
        metrics = dict(metrics, loss=loss, **opt_metrics)
        return new_params, new_opt, metrics

    return train_step
