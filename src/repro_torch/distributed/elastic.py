"""Elastic scaling: re-mesh and re-shard live state when the device pool
changes (node failure or capacity growth).

Counterpart of ``repro.distributed.elastic``. The checkpoint layout is
device-count-independent (whole host arrays, ``train.checkpoint``), so
elasticity reduces to: gather -> rebuild mesh/plan for the new topology ->
re-place. ``reshard_tree`` gathers each ``DTensor`` leaf (``full_tensor``,
a collective every rank joins) and distributes it on the new mesh by its
spec; both meshes span the ranks of one process group.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

import torch
from torch.distributed.tensor import DTensor, distribute_tensor

from repro_torch.distributed.axes import PartitionSpec, placements
from repro_torch.distributed.sharding import make_plan, param_pspecs


def reshard_tree(tree: Dict[str, torch.Tensor],
                 new_spec_tree: Dict[str, PartitionSpec], new_mesh):
    """Re-place a dict of tensors onto ``new_mesh`` by ``new_spec_tree``."""
    def one(x, spec):
        full = x.full_tensor() if isinstance(x, DTensor) else x
        # every rank holds the whole tensor: each keeps its shard, no copy
        return distribute_tensor(full, new_mesh, placements(spec, new_mesh),
                                 src_data_rank=None)
    return {k: one(x, new_spec_tree[k]) for k, x in tree.items()}


@dataclasses.dataclass
class ElasticContext:
    """Tracks the active mesh; rebuilds plans when the pool changes."""
    cfg: "ModelConfig"
    kind: str
    mesh: object
    plan: object = None

    def __post_init__(self):
        self.plan = make_plan(self.cfg, self.mesh, self.kind)

    def on_change(self, new_mesh, params, opt_state=None):
        """Re-shard live training state onto ``new_mesh``: params and the
        AdamW moments by the new plan; ``step``, a plain tensor that every
        rank holds alike, stays replicated as it is."""
        new_plan = make_plan(self.cfg, new_mesh, self.kind)
        specs = param_pspecs(params, new_plan.mapping)
        params = reshard_tree(params, specs, new_mesh)
        if opt_state is not None:
            opt_state = {"mu": reshard_tree(opt_state["mu"], specs, new_mesh),
                         "nu": reshard_tree(opt_state["nu"], specs, new_mesh),
                         "step": opt_state["step"]}
        self.mesh = new_mesh
        self.plan = new_plan
        return params, opt_state
