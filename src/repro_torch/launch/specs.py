"""Abstract inputs and step builders for the dry-run.

Counterpart of ``repro.launch.specs``. The reference's abstract trees are
``ShapeDtypeStruct``s; here they are tensors that hold no memory: the
model's ``meta`` initialisation, built outside any fake mode (its
initialisers cannot run inside one), and then fake tensors
(``FakeTensorMode``) of the same names, shapes and dtypes on the traced
device: float32 masters for training, the compute dtype for serving, a bf16
cache. ``build_cell`` distributes them over a ``DeviceMesh`` by the sharding
plan, so every rank holds its local shards, and returns the step that the
dry-run traces.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch
from torch import nn
from torch.func import functional_call

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.distributed import axes as axlib
from repro_torch.distributed.sharding import (batch_pspecs, cache_pspecs,
                                              make_plan, param_pspecs)
from repro_torch.models.lm import Model, build_model
from repro_torch.models.transformer import compute_dtype
from repro_torch.train.optimizer import AdamWConfig, adamw_init
from repro_torch.train.trainer import make_train_step, param_dict

Tree = Dict[str, torch.Tensor]


def sds(shape, dtype) -> torch.Tensor:
    """A ``meta`` tensor: a shape and a dtype, no memory."""
    return torch.empty(shape, dtype=dtype, device="meta")


def fake_tree(tree: Tree, fake_mode, device) -> Tree:
    """Fake tensors on ``device`` with ``tree``'s names, shapes and dtypes."""
    with fake_mode:
        return {k: torch.empty(v.shape, dtype=v.dtype, device=device)
                for k, v in tree.items()}


# ---------------------------------------------------------------------------
# Abstract inputs
# ---------------------------------------------------------------------------

def input_specs(cfg: ModelConfig, shape: ShapeConfig) -> Tree:
    """Stand-ins (``meta``) for every model input of this cell, with the
    reference's shapes and dtypes."""
    B = shape.global_batch
    S = shape.seq_len if shape.kind != "decode" else 1
    batch: Tree = {}
    if cfg.embed_stub and shape.kind != "decode":
        batch["embeds"] = sds((B, S, cfg.d_model), torch.bfloat16)
    else:
        batch["tokens"] = sds((B, S), torch.int32)
    if shape.kind == "train":
        batch["labels"] = sds((B, S), torch.int32)
    if (cfg.attention is not None and cfg.attention.rope == "mrope"
            and shape.kind != "decode"):
        batch["positions3"] = sds((B, S, 3), torch.int32)
    return batch


def abstract_params(model: Model, dtype=torch.float32) -> Tree:
    """The model's parameters by ``named_parameters()`` name (``meta``):
    matrices in ``dtype``, norms, biases and the recurrent mixers float32,
    as ``Model.init`` stores them."""
    return param_dict(model.init(0, device="meta", dtype=dtype))


def abstract_cache(model: Model, batch: int, max_len: int,
                   dtype=torch.bfloat16) -> Tree:
    return model.init_cache(batch, max_len, dtype, device="meta")


# ---------------------------------------------------------------------------
# Cell builder: (plan, fn, abstract args, in/out placements)
# ---------------------------------------------------------------------------

def auto_grad_accum(cfg: ModelConfig, shape: ShapeConfig, mesh,
                    budget_bytes: float = 4e9,
                    batch_axes=("pod", "data"), seq_shards: int = 1) -> int:
    """Pick microbatch accumulation so the remat's saved layer inputs
    (L x rows_per_device x S x d bf16) fit the activation budget."""
    sizes = axlib.mesh_shape(mesh)
    n_batch_devs = 1
    for ax in batch_axes:
        n_batch_devs *= sizes.get(ax, 1)
    rows = max(1, shape.global_batch // n_batch_devs)
    per_row = cfg.n_layers * shape.seq_len * cfg.d_model * 2 // seq_shards
    ga = 1
    while rows // ga > 1 and (rows // ga) * per_row > budget_bytes:
        ga *= 2
    return ga


class _Bound(nn.Module):
    """``method(tree, *args)`` of a model, called through ``functional_call``
    so that ``tree``'s parameters are the tensors it is given."""

    def __init__(self, model: Model, method: str, dtype):
        super().__init__()
        self.tree = model.init(0, device="meta", dtype=dtype)
        self.method = getattr(model, method)

    def forward(self, *args):
        return self.method(self.tree, *args)


def _bind(model: Model, method: str, dtype):
    bound = _Bound(model, method, dtype)

    def call(params: Tree, *args):
        return functional_call(bound, {f"tree.{k}": v for k, v in params.items()},
                               args, strict=True)
    return call


def build_cell(cfg: ModelConfig, shape: ShapeConfig, mesh,
               attn_impl: str = "auto",
               opt_cfg: Optional[AdamWConfig] = None,
               grad_accum: Optional[int] = None,
               variant: str = "baseline", *, fake_mode, device):
    """Returns (plan, fn, args, in_placements, out_placements): ``fn(*args)``
    is the cell's step on this rank, ``args`` fake ``DTensor``s of
    ``fake_mode`` on ``device`` laid out by the plan over ``mesh``.
    Training builds with ``remat=True`` and ``auto_grad_accum``."""
    plan = make_plan(cfg, mesh, "train" if shape.kind == "train" else shape.kind,
                     shape, variant=variant)
    c = plan.cfg
    mapping = plan.mapping

    def place(tree: Tree, specs) -> tuple:
        local = fake_tree(tree, fake_mode, device)
        with fake_mode:
            return (plan.distribute(local, specs),
                    {k: plan.placements(s) for k, s in specs.items()})

    batch_abs = input_specs(c, shape)
    batch, b_pl = place(batch_abs, batch_pspecs(c, mapping, batch_abs))

    if shape.kind == "train":
        model = build_model(c, attn_impl=attn_impl, remat=True)
        p_abs = abstract_params(model, torch.float32)
        params, p_pl = place(p_abs, param_pspecs(p_abs, mapping))
        with fake_mode:
            opt = adamw_init(params)
        o_pl = {"mu": p_pl, "nu": p_pl, "step": None}
        if grad_accum is None:
            baxes = mapping.get("batch") or ("data",)
            seq_ax = mapping.get("seq")
            seq_shards = axlib.mesh_shape(mesh).get(seq_ax, 1) if seq_ax else 1
            grad_accum = auto_grad_accum(c, shape, mesh, batch_axes=baxes,
                                         seq_shards=seq_shards)
        step = make_train_step(model, opt_cfg or AdamWConfig(),
                               grad_accum=grad_accum)

        def fn(params, opt_state, batch):
            with axlib.axis_env(mesh, mapping):
                return step(params, opt_state, batch)

        return (plan, fn, (params, opt, batch), (p_pl, o_pl, b_pl),
                (p_pl, o_pl, None))

    dtype = compute_dtype(c)
    model = build_model(c, attn_impl=attn_impl, remat=False)
    p_abs = abstract_params(model, dtype)
    params, p_pl = place(p_abs, param_pspecs(p_abs, mapping))

    if shape.kind == "prefill":
        prefill = _bind(model, "prefill", dtype)

        def fn(params, batch):
            with axlib.axis_env(mesh, mapping):
                return prefill(params, batch, shape.seq_len)

        return plan, fn, (params, batch), (p_pl, b_pl), None

    # decode: one new token against a cache of seq_len
    cache_abs = abstract_cache(model, shape.global_batch, shape.seq_len)
    cache, c_pl = place(cache_abs, cache_pspecs(c, mapping, cache_abs))
    decode = _bind(model, "decode_step", dtype)

    def fn(params, batch, cache):
        with axlib.axis_env(mesh, mapping):
            return decode(params, batch, cache)

    return (plan, fn, (params, batch, cache), (p_pl, b_pl, c_pl),
            (None, c_pl))
