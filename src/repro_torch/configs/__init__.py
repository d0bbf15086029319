"""Config registry: ``get_config(arch_id)`` and the assigned-arch list."""
from __future__ import annotations

from typing import Dict, List

from repro_torch.configs.base import (
    AttentionConfig,
    MLPConfig,
    MoEConfig,
    ModelConfig,
    RWKVConfig,
    SHAPES,
    SSMConfig,
    ShapeConfig,
    ZambaConfig,
    cell_is_runnable,
)

from repro_torch.configs.smollm_360m import CONFIG as _smollm
from repro_torch.configs.stablelm_1_6b import CONFIG as _stablelm
from repro_torch.configs.h2o_danube_1_8b import CONFIG as _danube
from repro_torch.configs.mistral_nemo_12b import CONFIG as _nemo
from repro_torch.configs.mixtral_8x22b import CONFIG as _mixtral
from repro_torch.configs.qwen3_moe_30b_a3b import CONFIG as _qwen3moe
from repro_torch.configs.qwen2_vl_2b import CONFIG as _qwen2vl
from repro_torch.configs.rwkv6_1_6b import CONFIG as _rwkv6
from repro_torch.configs.zamba2_1_2b import CONFIG as _zamba2
from repro_torch.configs.hubert_xlarge import CONFIG as _hubert
from repro_torch.configs.paper_models import PAPER_MODELS

# The 10 assigned architectures (``--arch <id>``).
ASSIGNED: Dict[str, ModelConfig] = {
    "smollm-360m": _smollm,
    "stablelm-1.6b": _stablelm,
    "h2o-danube-1.8b": _danube,
    "mistral-nemo-12b": _nemo,
    "mixtral-8x22b": _mixtral,
    "qwen3-moe-30b-a3b": _qwen3moe,
    "qwen2-vl-2b": _qwen2vl,
    "rwkv6-1.6b": _rwkv6,
    "zamba2-1.2b": _zamba2,
    "hubert-xlarge": _hubert,
}

REGISTRY: Dict[str, ModelConfig] = {**ASSIGNED, **PAPER_MODELS}


def get_config(arch: str) -> ModelConfig:
    if arch not in REGISTRY:
        raise KeyError(f"unknown arch {arch!r}; known: {sorted(REGISTRY)}")
    return REGISTRY[arch]


def get_shape(name: str) -> ShapeConfig:
    if name not in SHAPES:
        raise KeyError(f"unknown shape {name!r}; known: {sorted(SHAPES)}")
    return SHAPES[name]


def all_cells() -> List[tuple]:
    """All 40 (arch, shape) cells with runnability verdicts."""
    cells = []
    for arch, cfg in ASSIGNED.items():
        for sname, shape in SHAPES.items():
            ok, reason = cell_is_runnable(cfg, shape)
            cells.append((arch, sname, ok, reason))
    return cells


def reduced_config(cfg: ModelConfig) -> ModelConfig:
    """A tiny same-family config for CPU smoke tests."""
    import dataclasses
    kw = dict(
        name=cfg.name + "-reduced",
        n_layers=2,
        d_model=64,
        vocab_size=256,
        max_seq_len=128,
    )
    if cfg.attention is not None:
        a = cfg.attention
        n_heads = 4 if cfg.name != "smollm-360m" else 3  # keep the odd-head family trait
        n_kv = max(1, n_heads * a.n_kv_heads // a.n_heads)
        kw["attention"] = dataclasses.replace(
            a, n_heads=n_heads, n_kv_heads=n_kv, head_dim=16,
            sliding_window=32 if a.sliding_window else None,
        )
    if cfg.mlp is not None:
        kw["mlp"] = dataclasses.replace(cfg.mlp, d_ff=128)
    if cfg.moe is not None:
        kw["moe"] = dataclasses.replace(
            cfg.moe, n_experts=4, top_k=min(2, cfg.moe.top_k), d_expert=64
        )
    if cfg.ssm is not None:
        kw["ssm"] = dataclasses.replace(cfg.ssm, d_state=16, head_dim=16)
    if cfg.rwkv is not None:
        kw["rwkv"] = dataclasses.replace(
            cfg.rwkv, head_dim=16, decay_lora=8, mix_lora=8, gate_lora=8
        )
    if cfg.zamba is not None:
        kw["zamba"] = dataclasses.replace(cfg.zamba, shared_attn_every=1)
    return cfg.replace(**kw)


__all__ = [
    "ASSIGNED", "REGISTRY", "SHAPES", "PAPER_MODELS",
    "get_config", "get_shape", "all_cells", "reduced_config",
    "ModelConfig", "ShapeConfig", "AttentionConfig", "MLPConfig",
    "MoEConfig", "SSMConfig", "RWKVConfig", "ZambaConfig", "cell_is_runnable",
]
