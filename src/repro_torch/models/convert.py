"""Reference parameter trees -> the port's parameter modules.

``params_from_numpy`` takes the JAX package's parameter pytree as nested
dicts of numpy arrays (``jax.tree_util.tree_map(np.asarray, params)``) and
returns the port's parameter modules holding the same values in the same
layouts, with the layers unstacked from the leading ``L`` axis: a
``TransformerParams`` for the dense, MoE, VLM and audio families
(``init_transformer``; a MoE layer's router (D, E), up/gate (E, D, F) and
down (E, F, D)), an ``RWKVParams`` for RWKV6 (``init_rwkv``), a
``ZambaParams`` for Zamba2 (``init_zamba``; Mamba2 layers stacked on L,
shared blocks on copies). Matrices are stored in ``dtype`` (the compute
dtype by default; float32 for training's masters) once; norms, biases,
RWKV6's mixers, decay and bonus and Mamba2's conv weights, decays and norm
stay float32.

``opt_state_from_numpy`` takes the reference's AdamW state (``adamw_init``'s
``{"mu", "nu", "step"}``, as numpy) and returns the port's: ``mu`` and
``nu`` as dicts of float32 tensors keyed like ``named_parameters()``, and
``step``. Both together let one training step start from the same state in
both packages.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.attention import AttnParams
from repro_torch.models.layers import MLPParams, NormParams
from repro_torch.models.lm import check_supported
from repro_torch.models.mamba import MambaParams
from repro_torch.models.moe import MoEParams
from repro_torch.models.rwkv import (RWKVBlockParams, RWKVLayerParams,
                                     RWKVParams)
from repro_torch.models.transformer import (LayerParams, TransformerParams,
                                            compute_dtype)
from repro_torch.models.zamba import SharedBlockParams, ZambaParams


def _norm(tree: Dict, device) -> NormParams:
    f32 = lambda a: torch.tensor(np.asarray(a, np.float32), device=device)
    return NormParams(f32(tree["scale"]),
                      f32(tree["bias"]) if "bias" in tree else None)


def _at(tree: Dict, i: int) -> Dict:
    """Entry ``i`` of every leaf of a stacked tree."""
    return {k: _at(v, i) if isinstance(v, dict) else v[i] for k, v in tree.items()}


def params_from_numpy(tree: Dict, cfg: ModelConfig, device,
                      dtype: Optional[torch.dtype] = None):
    check_supported(cfg)
    dtype = compute_dtype(cfg) if dtype is None else dtype
    if cfg.family == "ssm":
        return _rwkv_from_numpy(tree, cfg, device, dtype)
    mat = lambda a: torch.tensor(np.asarray(a, np.float32), dtype=dtype,
                                 device=device)
    f32 = lambda a: torch.tensor(np.asarray(a, np.float32), dtype=torch.float32,
                                 device=device)

    def attention(at):
        biases = {k: f32(at[k]) for k in ("bq", "bk", "bv") if k in at}
        return AttnParams(mat(at["wq"]), mat(at["wk"]), mat(at["wv"]),
                          mat(at["wo"]), **biases)

    def mlp(ml):
        return MLPParams(mat(ml["up"]), mat(ml["down"]),
                         mat(ml["gate"]) if "gate" in ml else None)

    if cfg.family == "hybrid":
        layers = [MambaParams(**{
            k: (mat if k in MambaParams.MATRICES else f32)(v)
            for k, v in _at(tree["layers"], i).items()})
            for i in range(cfg.n_layers)]
        shared = []
        for g in range(cfg.zamba.shared_attn_copies):
            sp = _at(tree["shared"], g)
            shared.append(SharedBlockParams(
                _norm(sp["attn_norm"], device), attention(sp["attn"]),
                _norm(sp["mlp_norm"], device), mlp(sp["mlp"])))
        return ZambaParams(mat(tree["embed"]), layers, shared,
                           _norm(tree["final_norm"], device),
                           mat(tree["lm_head"]))
    layers = []
    for i in range(cfg.n_layers):
        lp = _at(tree["layers"], i)
        ffn = ({"moe": MoEParams(*(mat(lp["moe"][k]) for k in
                                   ("router", "up", "gate", "down")))}
               if "moe" in lp else {"mlp": mlp(lp["mlp"])})
        layers.append(LayerParams(_norm(lp["attn_norm"], device),
                                  attention(lp["attn"]),
                                  _norm(lp["mlp_norm"], device), **ffn))
    lm_head = None if cfg.tie_embeddings else mat(tree["lm_head"])
    return TransformerParams(mat(tree["embed"]), lm_head, layers,
                             _norm(tree["final_norm"], device))


def _rwkv_from_numpy(tree: Dict, cfg: ModelConfig, device,
                     dtype: torch.dtype) -> RWKVParams:
    def t(a, matrix=False):
        return torch.tensor(np.asarray(a, np.float32), device=device,
                            dtype=dtype if matrix else torch.float32)

    L = tree["layers"]
    layers = []
    for i in range(cfg.n_layers):
        block = RWKVBlockParams(**{
            k: t(v[i], k in RWKVBlockParams.MATRICES) for k, v in L.items()})
        layers.append(RWKVLayerParams(
            _norm({"scale": tree["ln1_scale"][i], "bias": tree["ln1_bias"][i]}, device),
            _norm({"scale": tree["ln2_scale"][i], "bias": tree["ln2_bias"][i]}, device),
            block))
    return RWKVParams(
        t(tree["embed"], True),
        _norm({"scale": tree["ln0_scale"], "bias": tree["ln0_bias"]}, device),
        layers,
        _norm({"scale": tree["final_scale"], "bias": tree["final_bias"]}, device),
        t(tree["lm_head"], True))


def opt_state_from_numpy(state: Dict, cfg: ModelConfig, device) -> Dict:
    """The reference's AdamW state -> the port's (``repro_torch.train.
    optimizer.adamw_init``'s layout)."""
    named = lambda tree: {
        name: p.detach() for name, p in params_from_numpy(
            tree, cfg, device, dtype=torch.float32).named_parameters()}
    return {"mu": named(state["mu"]), "nu": named(state["nu"]),
            "step": torch.tensor(int(np.asarray(state["step"])),
                                 dtype=torch.int32, device=device)}
