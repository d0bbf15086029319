"""AdamW with linear-warmup cosine decay, over dicts of named tensors.

Counterpart of ``repro.train.optimizer``, with its math: float32 moments,
clipping by the global norm, bias correction, decoupled weight decay on
matrices only. Parameters, gradients and moments are dicts keyed by the
parameter module's ``named_parameters()`` names; ``adamw_update`` returns
new tensors and leaves its inputs as they were, as the reference's pure
function does. Everything stays on the parameters' device: no value is read
back to the host. ``DTensor`` parameters (a mesh) keep their placements;
their moments and updates take the same.

Weight decay follows the rank of the reference's leaf, not the port's
tensor. The reference stacks its layers (and Zamba2's shared blocks) on a
leading axis, so every per-layer leaf there has one more dimension than the
port's per-layer tensor and is decayed, norms and biases included; at the top
level (embeddings, heads, final and input norms) the ranks agree.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Tuple

import torch

from repro_torch.distributed.axes import to_plain

Tree = Dict[str, torch.Tensor]

# name prefixes of the port's parameters that the reference stacks on a
# leading axis (layers; Zamba2's shared blocks, stacked over copies)
STACKED = ("layers.", "shared.")


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 10_000
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0


def schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    step = step.float()
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    prog = torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1), 0, 1)
    cos = 0.5 * (1 + torch.cos(math.pi * prog))
    return cfg.lr * warm * (0.1 + 0.9 * cos)


def adamw_init(params: Tree) -> Dict:
    """Zero float32 moments laid out as the parameters (a ``DTensor``'s
    moments are ``DTensor``s of its placements) and a step counter."""
    zeros = lambda p: torch.zeros_like(p, dtype=torch.float32)
    device = next(iter(params.values())).device
    return {"mu": {k: zeros(p) for k, p in params.items()},
            "nu": {k: zeros(p) for k, p in params.items()},
            "step": torch.zeros((), dtype=torch.int32, device=device)}


def global_norm(tree: Tree) -> torch.Tensor:
    """The norm of all leaves together; a ``DTensor`` leaf's sum of squares
    is summed over its shards (``to_plain``), so every rank clips alike."""
    return torch.sqrt(torch.sum(torch.stack(
        [to_plain(torch.sum(torch.square(x.float()))) for x in tree.values()])))


def reference_ndim(name: str, p: torch.Tensor) -> int:
    """The rank of the reference's leaf that parameter ``name`` maps to."""
    return p.ndim + (1 if name.startswith(STACKED) else 0)


@torch.no_grad()
def adamw_update(cfg: AdamWConfig, grads: Tree, state: Dict, params: Tree
                 ) -> Tuple[Tree, Dict, Dict[str, torch.Tensor]]:
    step = state["step"] + 1
    lr = schedule(cfg, step)
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.grad_clip / torch.clamp(gnorm, min=1e-9), max=1.0)
    stepf = step.float()
    bc1 = 1 - torch.pow(torch.tensor(cfg.b1, device=stepf.device), stepf)
    bc2 = 1 - torch.pow(torch.tensor(cfg.b2, device=stepf.device), stepf)
    new_p, new_m, new_v = {}, {}, {}
    for name, p in params.items():
        g = grads[name].float() * scale
        m = cfg.b1 * state["mu"][name] + (1 - cfg.b1) * g
        v = cfg.b2 * state["nu"][name] + (1 - cfg.b2) * torch.square(g)
        delta = (m / bc1) / (torch.sqrt(v / bc2) + cfg.eps)
        if reference_ndim(name, p) >= 2:  # decoupled weight decay on matrices only
            delta = delta + cfg.weight_decay * p.float()
        new_p[name] = (p.float() - lr * delta).to(p.dtype)
        new_m[name], new_v[name] = m, v
    return (new_p, {"mu": new_m, "nu": new_v, "step": step},
            {"grad_norm": gnorm, "lr": lr})
