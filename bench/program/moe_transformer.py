"""The program under test for the MoE transformer family: ``repro_torch``'s
model at a configuration file's sizes, over the benchmark's own weights.

``build`` hands the tensors that ``reference.moe_transformer.draw`` made to
``repro_torch``'s parameter containers as they are (views, no copies), so
the program and the reference read the same weights.
"""
from __future__ import annotations

from typing import Dict

import torch

from bench.reference.moe_transformer import dims


def build(cfg: Dict, W: Dict[str, torch.Tensor]):
    """(model, params) of ``repro_torch`` with the flash and decode
    kernels (``attn_impl="kernel"``)."""
    from repro_torch.configs.base import (AttentionConfig, MLPConfig,
                                          MoEConfig, ModelConfig)
    from repro_torch.models import build_model
    from repro_torch.models.attention import AttnParams
    from repro_torch.models.layers import NormParams
    from repro_torch.models.moe import MoEParams
    from repro_torch.models.transformer import LayerParams, TransformerParams
    d = dims(cfg)
    if cfg["capacity_factor"] != 1.25:
        raise ValueError("repro_torch's MoE dispatch runs at capacity factor "
                         "1.25 only")
    model_cfg = ModelConfig(
        name=cfg["name"], family="moe", n_layers=d.L, d_model=d.D,
        vocab_size=d.V,
        attention=AttentionConfig(n_heads=d.H, n_kv_heads=d.KV, head_dim=d.Dh,
                                  sliding_window=d.window, rope_theta=d.theta),
        mlp=MLPConfig(d_ff=d.F, activation=cfg["hidden_act"], gated=True),
        moe=MoEConfig(n_experts=d.E, top_k=d.K, d_expert=d.F),
        norm="rmsnorm", norm_eps=d.eps,
        tie_embeddings=cfg["tie_word_embeddings"],
        max_seq_len=cfg["max_position_embeddings"], dtype=cfg["torch_dtype"])
    layers = [
        LayerParams(NormParams(W["attn_norm"][l]),
                    AttnParams(W["wq"][l], W["wk"][l], W["wv"][l], W["wo"][l]),
                    NormParams(W["mlp_norm"][l]),
                    moe=MoEParams(W["router"][l], W["up"][l], W["gate"][l],
                                  W["down"][l]))
        for l in range(d.L)]
    params = TransformerParams(W["embed"], W["lm_head"], layers,
                               NormParams(W["final_norm"]))
    return build_model(model_cfg, attn_impl="kernel"), params
