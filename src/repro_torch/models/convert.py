"""Reference parameter trees -> the port's parameter modules.

``params_from_numpy`` takes the JAX package's parameter pytree as nested
dicts of numpy arrays (``jax.tree_util.tree_map(np.asarray, params)``) and
returns a ``TransformerParams`` holding the same values in the same layouts,
with the layers unstacked from the leading ``L`` axis. Matrices are stored
in ``dtype`` (the compute dtype) once; norm scales and biases stay float32.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.attention import AttnParams
from repro_torch.models.layers import MLPParams, NormParams
from repro_torch.models.transformer import (LayerParams, TransformerParams,
                                            check_supported, compute_dtype)


def _norm(tree: Dict, device) -> NormParams:
    f32 = lambda a: torch.tensor(np.asarray(a, np.float32), device=device)
    return NormParams(f32(tree["scale"]),
                      f32(tree["bias"]) if "bias" in tree else None)


def params_from_numpy(tree: Dict, cfg: ModelConfig, device,
                      dtype: Optional[torch.dtype] = None) -> TransformerParams:
    check_supported(cfg)
    dtype = compute_dtype(cfg) if dtype is None else dtype
    mat = lambda a: torch.tensor(np.asarray(a, np.float32), dtype=dtype,
                                 device=device)
    f32 = lambda a: torch.tensor(np.asarray(a, np.float32), dtype=torch.float32,
                                 device=device)
    L = tree["layers"]
    layers = []
    for i in range(cfg.n_layers):
        at = {k: v[i] for k, v in L["attn"].items()}
        biases = {k: f32(at[k]) for k in ("bq", "bk", "bv") if k in at}
        ml = {k: v[i] for k, v in L["mlp"].items()}
        layers.append(LayerParams(
            _norm({k: v[i] for k, v in L["attn_norm"].items()}, device),
            AttnParams(mat(at["wq"]), mat(at["wk"]), mat(at["wv"]),
                       mat(at["wo"]), **biases),
            _norm({k: v[i] for k, v in L["mlp_norm"].items()}, device),
            MLPParams(mat(ml["up"]), mat(ml["down"]),
                      mat(ml["gate"]) if "gate" in ml else None)))
    lm_head = None if cfg.tie_embeddings else mat(tree["lm_head"])
    return TransformerParams(mat(tree["embed"]), lm_head, layers,
                             _norm(tree["final_norm"], device))
