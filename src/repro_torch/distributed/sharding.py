"""Sharding plans: parameter/activation/cache specs per (arch, mesh,
run-kind).

Counterpart of ``repro.distributed.sharding``, with its rules. Logical
parameter axes are assigned from parameter names (weight layouts are
head-major, so specs align with head boundaries); physical mappings
implement:

  - TP "head" mode  : q heads sharded over ``model``; KV heads replicated
                      ``kv_repeat``x when KV < TP (MaxText-style)
  - TP "head_dim"   : fallback when head counts don't divide TP
                      (smollm 15H, qwen2-vl 12H): shard head_dim instead
  - FSDP            : parameter d_model/embed dims additionally sharded
                      over ``data`` (+ ``pod``) for training and for
                      models whose bf16 weights exceed per-device memory
  - EP               : MoE expert dim sharded over ``model`` when the
                      expert count divides it (qwen3: 128e), else experts
                      are TP-sharded internally (mixtral: 8e)
  - SP (long_500k)  : KV-cache sequence dim sharded over ``data``/``pod``
                      for batch=1 long-context decode

The functions read a mesh's axis names and sizes only (``axes.mesh_shape``),
so they plan without a process group. Parameters are the port's
``named_parameters()`` dicts: its layers are unstacked (``layers.3.attn.wq``),
so a leaf's tuple is the reference's without the stacked leading axis.

One deliberate difference: ``needs_fsdp``'s per-device memory defaults to
one NVIDIA H100 80GB HBM3's (``H100_HBM_BYTES``), not the reference's 16e9
of a TPU v5e, and ``make_mapping``/``make_plan`` pass ``hbm_per_chip``
through to it.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch
from torch.distributed.tensor import distribute_tensor

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.distributed.axes import (PartitionSpec, logical_to_spec,
                                          mesh_shape, placements)

# NVIDIA H100 80GB HBM3 (SXM5): 80 GB of device memory, the data sheet's
# figure; the memory budget of needs_fsdp's serving rule
H100_HBM_BYTES = 80e9

# ---------------------------------------------------------------------------
# TP mode selection
# ---------------------------------------------------------------------------


def tp_degree(mesh) -> int:
    return mesh_shape(mesh).get("model", 1)


def attention_tp_mode(cfg: ModelConfig, tp: int) -> str:
    a = cfg.attention
    if a is None:
        return "head"
    if a.n_heads % tp == 0 and (a.n_kv_heads % tp == 0 or tp % a.n_kv_heads == 0):
        return "head"
    if a.head_dim % tp == 0:
        return "head_dim"
    return "replicated"


def kv_repeat_for(cfg: ModelConfig, tp: int) -> int:
    a = cfg.attention
    if a is None or attention_tp_mode(cfg, tp) != "head":
        return 1
    if a.n_kv_heads % tp == 0:
        return 1
    return tp // a.n_kv_heads


def needs_fsdp(cfg: ModelConfig, tp: int, kind: str,
               hbm_per_chip: float = H100_HBM_BYTES) -> bool:
    if kind == "train":
        return True  # fp32 master + Adam moments always 2D-sharded
    bytes_per_chip = cfg.param_count() * 2 / tp
    return bytes_per_chip > 0.45 * hbm_per_chip


def moe_ep(cfg: ModelConfig, tp: int) -> bool:
    return cfg.moe is not None and cfg.moe.n_experts % tp == 0


# ---------------------------------------------------------------------------
# Logical mappings
# ---------------------------------------------------------------------------

def make_mapping(cfg: ModelConfig, mesh, kind: str,
                 shape: Optional[ShapeConfig] = None,
                 variant: str = "baseline",
                 hbm_per_chip: float = H100_HBM_BYTES) -> Dict[str, Any]:
    """Logical axis -> physical mesh axis mapping for params + activations.

    Variants:
      baseline : TP over `model`, FSDP over `data` where needed
      dp       : no tensor parallelism — batch sharded over BOTH axes,
                 weights FSDP-sharded 2D for storage, gathered per layer
      hd       : force head_dim-sharded attention (kv_repeat = 1)
      sp       : baseline + Megatron-style sequence parallelism — the
                 residual stream is seq-sharded over `model`
    """
    tp = tp_degree(mesh)
    multi_pod = "pod" in mesh_shape(mesh)
    batch_axes = ("pod", "data") if multi_pod else ("data",)
    if variant == "dp":
        batch_axes = batch_axes + ("model",)
        return {
            "batch": batch_axes, "seq": None, "seq_inner": None,
            "embed": None,
            "heads": None, "kv_heads": None, "head_dim": None,
            "vocab": None, "expert": None, "capacity": None,
            "mlp_act": None, "cache_seq": None,
            # 2D storage sharding; gathered per layer for compute
            "p_vocab": "model",
            "p_embed": ("data",),
            "p_heads": ("model" if (cfg.attention is not None and
                                    cfg.attention.n_heads % tp == 0)
                        else None),
            "p_kv": ("model" if (cfg.attention is not None and
                                 cfg.attention.n_kv_heads % tp == 0)
                     else None),
            "p_head_dim": None,
            "p_mlp": "model",
            "p_expert": ("model" if (cfg.moe is not None
                                     and cfg.moe.n_experts % tp == 0)
                         else None),
            "p_mlp_expert": (None if (cfg.moe is not None
                                      and cfg.moe.n_experts % tp == 0)
                             else "model"),
        }
    mode = attention_tp_mode(cfg, tp)
    if variant == "hd":
        mode = "head_dim" if (cfg.attention is not None
                              and cfg.attention.head_dim % tp == 0) else mode
    fsdp = needs_fsdp(cfg, tp, kind, hbm_per_chip)
    ep = moe_ep(cfg, tp)
    a = cfg.attention
    vocab_ok = cfg.vocab_size % tp == 0

    mapping: Dict[str, Any] = {
        # --- activations ---
        "batch": batch_axes,
        "seq": "model" if variant == "sp" else None,
        "seq_inner": None,
        "embed": None,
        "heads": "model" if mode == "head" else None,
        "kv_heads": "model" if (mode == "head" and a is not None
                                and a.n_kv_eff % tp == 0) else None,
        "head_dim": "model" if mode == "head_dim" else None,
        "vocab": "model" if vocab_ok else None,
        "expert": "model" if ep else None,
        "capacity": batch_axes,
        "mlp_act": "model",
        # --- parameters ---
        "p_vocab": "model" if vocab_ok else None,
        "p_embed": batch_axes if fsdp else None,
        "p_heads": "model" if mode == "head" else None,
        "p_kv": "model" if (mode == "head" and a is not None
                            and a.n_kv_heads % tp == 0) else None,
        "p_head_dim": "model" if mode == "head_dim" else None,
        "p_mlp": "model",
        "p_expert": "model" if ep else None,
    }
    if ep:
        mapping["p_mlp_expert"] = None   # expert dim takes the model axis
    else:
        mapping["p_mlp_expert"] = "model"
    # long-context decode: shard cache sequence over the batch axes
    if shape is not None and shape.kind == "decode" and shape.global_batch == 1:
        mapping["cache_seq"] = batch_axes
        mapping["batch"] = None
        mapping["capacity"] = None
    else:
        mapping["cache_seq"] = None
    return mapping


# ---------------------------------------------------------------------------
# Parameter specs from parameter names
# ---------------------------------------------------------------------------

_RULES_3D = {
    "wq": ("p_embed", "p_heads", "p_head_dim"),
    "wk": ("p_embed", "p_kv", "p_head_dim"),
    "wv": ("p_embed", "p_kv", "p_head_dim"),
    "wo": ("p_heads", "p_head_dim", "p_embed"),
    "wr": ("p_embed", "p_heads", "p_head_dim"),
    "wg": ("p_embed", "p_heads", "p_head_dim"),
    "in_z": ("p_embed", "p_heads", "p_head_dim"),
    "in_x": ("p_embed", "p_heads", "p_head_dim"),
    "out_proj": ("p_heads", "p_head_dim", "p_embed"),
    "conv_x_w": (None, "p_heads", "p_head_dim"),
    "decay_lora_b": (None, "p_heads", "p_head_dim"),
    "up": ("p_expert", "p_embed", "p_mlp_expert"),     # MoE (E, d, f)
    "gate": ("p_expert", "p_embed", "p_mlp_expert"),
    "down": ("p_expert", "p_mlp_expert", "p_embed"),
    "mix_lora_a": (None, "p_embed", None),
    "mix_lora_b": (None, None, "p_embed"),
}

_RULES_2D = {
    "embed": ("p_vocab", "p_embed"),
    "lm_head": ("p_vocab", "p_embed"),
    "up": ("p_embed", "p_mlp"),
    "gate": ("p_embed", "p_mlp"),
    "down": ("p_mlp", "p_embed"),
    "cm_key": ("p_embed", "p_mlp"),
    "cm_value": ("p_mlp", "p_embed"),
    "cm_recept": ("p_embed", None),
    "router": ("p_embed", None),
    "bq": ("p_heads", "p_head_dim"),
    "bk": ("p_kv", "p_head_dim"),
    "bv": ("p_kv", "p_head_dim"),
    "u": ("p_heads", "p_head_dim"),
    "w0": ("p_heads", "p_head_dim"),
    "ln_x_scale": ("p_heads", "p_head_dim"),
    "ln_x_bias": ("p_heads", "p_head_dim"),
    "norm_scale": ("p_heads", "p_head_dim"),
    "conv_x_b": ("p_heads", "p_head_dim"),
    "in_B": ("p_embed", None),
    "in_C": ("p_embed", None),
    "in_dt": ("p_embed", "p_heads"),
    "decay_lora_a": ("p_embed", None),
    "conv_bc_w": (None, None),
    "maa": (None, None),
}

_RULES_1D = {
    "A_log": ("p_heads",),
    "dt_bias": ("p_heads",),
    "D_skip": ("p_heads",),
}


def leaf_logical(name: str, ndim: int) -> Tuple[Optional[str], ...]:
    """The logical axes of parameter ``name`` (a ``named_parameters()``
    name; the rule is its last component's) of rank ``ndim``."""
    leaf = name.rsplit(".", 1)[-1]
    rule = None
    if ndim == 3:
        rule = _RULES_3D.get(leaf)
        # MoE expert tensors are 3D even unstacked; rwkv mix loras too.
        if rule is None and leaf in _RULES_2D:
            rule = _RULES_2D[leaf]
    elif ndim == 2:
        rule = _RULES_2D.get(leaf)
    elif ndim == 1:
        rule = _RULES_1D.get(leaf)
    if rule is None:
        rule = (None,) * ndim
    return tuple(rule[:ndim]) + (None,) * max(0, ndim - len(rule))


def _named(params) -> Dict[str, Any]:
    if isinstance(params, torch.nn.Module):
        return dict(params.named_parameters())
    return dict(params)


def param_logical_tree(params) -> Dict[str, Tuple[Optional[str], ...]]:
    """{name: logical-axis tuple} of a dict of named tensors (or a module's
    ``named_parameters()``)."""
    return {name: leaf_logical(name, len(p.shape))
            for name, p in _named(params).items()}


def param_pspecs(params, mapping: Dict[str, Any]) -> Dict[str, PartitionSpec]:
    return {name: logical_to_spec(ax, mapping)
            for name, ax in param_logical_tree(params).items()}


# ---------------------------------------------------------------------------
# Batch / cache specs
# ---------------------------------------------------------------------------

def batch_pspecs(cfg: ModelConfig, mapping: Dict[str, Any],
                 batch_tree: Dict[str, Any]) -> Dict[str, PartitionSpec]:
    def spec_for(name, leaf):
        nd = len(leaf.shape)
        if name in ("tokens", "labels", "valid"):
            return logical_to_spec(("batch", None)[:nd] + (None,) * (nd - 2),
                                   mapping)
        if name == "embeds":
            return logical_to_spec(("batch", None, None), mapping)
        if name == "positions3":
            return logical_to_spec(("batch", None, None), mapping)
        if name == "lengths":
            return logical_to_spec((None,), mapping)
        return PartitionSpec()
    return {k: spec_for(k, v) for k, v in batch_tree.items()}


def _cache_spec(name: str, mapping: Dict[str, Any]) -> PartitionSpec:
    if name in ("k", "v"):
        # (L|n_app, B, W, KV_eff, Dh)
        return logical_to_spec(
            (None, "batch", "cache_seq", "kv_heads", "head_dim"), mapping)
    if name == "lengths":
        return logical_to_spec((None,), mapping)
    if name == "wkv":       # (L, B, H, K, K)
        return logical_to_spec((None, "batch", "heads", None, None), mapping)
    if name in ("tm_shift", "cm_shift"):   # (L, B, D)
        return logical_to_spec((None, "batch", None), mapping)
    if name == "ssm":       # (L, B, H, N, P)
        return logical_to_spec((None, "batch", "heads", None, None), mapping)
    if name == "conv_x":    # (L, B, K-1, H, P)
        return logical_to_spec((None, "batch", None, "heads", "head_dim"),
                               mapping)
    if name == "conv_bc":   # (L, B, K-1, 2GN)
        return logical_to_spec((None, "batch", None, None), mapping)
    return PartitionSpec()


def cache_pspecs(cfg: ModelConfig, mapping: Dict[str, Any], cache_tree):
    """Specs for a decode cache (nested dicts; a leaf's rule is its key's)."""
    def walk(tree, name):
        if isinstance(tree, dict):
            return {k: walk(v, k) for k, v in tree.items()}
        return _cache_spec(name, mapping)
    return walk(cache_tree, "")


# ---------------------------------------------------------------------------
# Plan facade
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class ShardingPlan:
    cfg: ModelConfig            # with kv_repeat applied
    mesh: Any                   # a DeviceMesh (or a planning stand-in)
    mapping: Dict[str, Any]
    kind: str                   # train | prefill | decode

    def placements(self, spec: PartitionSpec) -> list:
        return placements(spec, self.mesh)

    def distribute(self, tree: Dict[str, torch.Tensor],
                   spec_tree: Dict[str, PartitionSpec]) -> Dict[str, Any]:
        """``DTensor``s of a dict of whole tensors, each by its spec. Every
        rank holds the same whole tensors (drawn from one seed, or one
        batch) and keeps its shards: nothing is sent."""
        return {k: distribute_tensor(v, self.mesh, self.placements(spec_tree[k]),
                                     src_data_rank=None)
                for k, v in tree.items()}


def make_plan(cfg: ModelConfig, mesh, kind: str,
              shape: Optional[ShapeConfig] = None,
              variant: str = "baseline",
              hbm_per_chip: float = H100_HBM_BYTES) -> ShardingPlan:
    tp = tp_degree(mesh)
    rep = 1 if variant in ("dp", "hd") else kv_repeat_for(cfg, tp)
    if cfg.attention is not None and rep != cfg.attention.kv_repeat:
        cfg = cfg.replace(attention=dataclasses.replace(
            cfg.attention, kv_repeat=rep))
    mapping = make_mapping(cfg, mesh, kind, shape, variant, hbm_per_chip)
    return ShardingPlan(cfg=cfg, mesh=mesh, mapping=mapping, kind=kind)
