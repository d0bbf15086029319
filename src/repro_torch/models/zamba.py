"""Zamba2 hybrid stack: Mamba2 backbone + shared attention blocks.

Counterpart of ``repro.models.zamba``. Before each segment of
``shared_attn_every`` backbone layers, shared block ``g % copies`` (attention
+ MLP) is applied, each application ``g`` with its own KV cache. The
reference ``lax.scan``s over a segment's layers; here they are a Python
loop. As in the reference (and unlike the released Zamba2), the shared
block reads the residual stream, and there are no per-application LoRA
adapters.

Decode cache: k/v (n_app, B, W, KV, D), conv_x and conv_bc (L, B, K-1, ...)
and ssm (L, B, H, N, P) float32, and the lengths. Training
(``mode="train"``) rematerialises the Mamba2 layers (not the shared blocks)
when asked, as the reference's ``jax.checkpoint`` of its Mamba2 scan body.
"""
from __future__ import annotations

import functools
from typing import Dict, List, Optional

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed.axes import add_to_stream, constrain
from repro_torch.models import attention as attn
from repro_torch.models.layers import (apply_mlp, apply_norm, as_param,
                                       embed_init, mlp_params, norm_params,
                                       rematerialized)
from repro_torch.models.mamba import (MambaParams, mamba_block,
                                      mamba_block_params, mamba_state_shapes)
from repro_torch.models.transformer import (fill_cache_from_prefill,
                                            write_prefill_to_cache)

STATES = ("conv_x", "conv_bc", "ssm")


def n_shared_applications(cfg: ModelConfig) -> int:
    every = cfg.zamba.shared_attn_every
    return (cfg.n_layers + every - 1) // every


class SharedBlockParams(nn.Module):
    def __init__(self, attn_norm, attn_p, mlp_norm, mlp):
        super().__init__()
        self.attn_norm = attn_norm
        self.attn = attn_p
        self.mlp_norm = mlp_norm
        self.mlp = mlp


class ZambaParams(nn.Module):
    """embed and untied lm_head (V, D) in ``init_zamba``'s dtype, the Mamba2
    layers, the ``shared_attn_copies`` shared blocks, the final norm."""

    def __init__(self, embed, layers: List[MambaParams],
                 shared: List[SharedBlockParams], final_norm, lm_head):
        super().__init__()
        self.embed = as_param(embed)
        self.layers = nn.ModuleList(layers)
        self.shared = nn.ModuleList(shared)
        self.final_norm = final_norm
        self.lm_head = as_param(lm_head)


def init_zamba(cfg: ModelConfig, generator: torch.Generator,
               device: torch.device, dtype: torch.dtype) -> ZambaParams:
    d = cfg.d_model
    layers = [mamba_block_params(cfg, generator, device, dtype)
              for _ in range(cfg.n_layers)]
    shared = [SharedBlockParams(
        norm_params(d, cfg.norm, device),
        attn.attn_params(d, cfg.attention, generator, device, dtype),
        norm_params(d, cfg.norm, device),
        mlp_params(d, cfg.mlp.d_ff, cfg.mlp.gated, generator, device, dtype))
        for _ in range(cfg.zamba.shared_attn_copies)]
    embed = embed_init(cfg.vocab_size, d, generator, device, dtype)
    lm_head = embed_init(cfg.vocab_size, d, generator, device, dtype)
    return ZambaParams(embed, layers, shared, norm_params(d, cfg.norm, device),
                       lm_head)


def init_zamba_cache(cfg: ModelConfig, batch: int, max_len: int, device,
                     dtype=torch.bfloat16) -> Dict:
    """Zeros; k/v and the conv states in ``dtype``, ssm in float32, as the
    reference's ``init_zamba_cache``."""
    n_app = n_shared_applications(cfg)
    a = cfg.attention
    W = attn.cache_window(a, max_len)
    zeros = lambda shape, dt: torch.zeros(shape, dtype=dt, device=device)
    ss = mamba_state_shapes(cfg, batch)
    return {
        "k": zeros((n_app, batch, W, a.n_kv_eff, a.head_dim), dtype),
        "v": zeros((n_app, batch, W, a.n_kv_eff, a.head_dim), dtype),
        "conv_x": zeros(ss["conv_x"], dtype),
        "conv_bc": zeros(ss["conv_bc"], dtype),
        "ssm": zeros(ss["ssm"], torch.float32),
        "lengths": torch.zeros(batch, dtype=torch.int32, device=device),
    }


def _shared_apply(x, sp: SharedBlockParams, cfg: ModelConfig, *, rope, mode,
                  cache_kv, lengths, impl, kv_valid=None):
    h = constrain(apply_norm(x, sp.attn_norm, cfg.norm, cfg.norm_eps),
                  ("batch", "seq_inner", "embed"))
    a_out, new_kv = attn.attention_block(
        h, sp.attn, cfg.attention, rope=rope, mode=mode, cache=cache_kv,
        lengths=lengths, kv_valid=kv_valid, impl=impl)
    x = add_to_stream(x, a_out)
    h = constrain(apply_norm(x, sp.mlp_norm, cfg.norm, cfg.norm_eps),
                  ("batch", "seq_inner", "embed"))
    return add_to_stream(x, apply_mlp(h, sp.mlp, cfg.mlp.activation,
                                      cfg.mlp.gated)), new_kv


def _train_mamba(h, lp: MambaParams, cfg: ModelConfig):
    return constrain(mamba_block(h, lp, cfg, mode="train")[0],
                     ("batch", "seq", "embed"))


def zamba_forward(params: ZambaParams, cfg: ModelConfig, x, *, positions,
                  mode: str = "prefill", cache: Optional[Dict] = None,
                  kv_valid: Optional[torch.Tensor] = None,
                  attn_impl: str = "kernel", remat: bool = False,
                  remat_policy: str = "minimal"):
    """x: (B,S,D); kv_valid (B,S) the valid keys of a right-padded batch
    (the shared attention masks them; the Mamba2 layers scan over the
    padding, as the reference's). Returns (hidden, states).

    prefill: scans from zero states and returns ``{"computed_k",
    "computed_v"}`` (n_app, B, S, KV, D) and the new ``conv_x``,
    ``conv_bc`` and ``ssm`` stacked over layers. decode: reads ``cache``,
    writes its K/V and states in place and returns it with ``lengths + 1``.
    A conv state held in another dtype than x's is first recast to x's, as
    the reference's decode returns its states in x's dtype. train: scans
    from zero states (Mamba2 through ``gla_chunked``) and returns the aux
    loss, 0, in place of states; with ``remat`` each Mamba2 layer is
    rematerialised under ``remat_policy``."""
    every = cfg.zamba.shared_attn_every
    copies = cfg.zamba.shared_attn_copies
    decode = mode == "decode"
    lengths = cache["lengths"] if decode else None
    rope = attn.positional_angles(cfg.attention, positions)
    if mode == "train":
        h = x
        for g in range(n_shared_applications(cfg)):
            h, _ = _shared_apply(h, params.shared[g % copies], cfg, rope=rope,
                                 mode=mode, cache_kv=None, lengths=None,
                                 impl=attn_impl, kv_valid=kv_valid)
            for i in range(g * every, min((g + 1) * every, cfg.n_layers)):
                layer = functools.partial(_train_mamba, lp=params.layers[i],
                                          cfg=cfg)
                h = (rematerialized(layer, remat_policy) if remat else layer)(h)
        return h, torch.zeros((), dtype=torch.float32, device=h.device)
    if decode:
        for key in ("conv_x", "conv_bc"):
            if cache[key].dtype != x.dtype:
                cache[key] = cache[key].to(x.dtype)
    computed_k, computed_v = [], []
    new = {key: [] for key in STATES}
    h = x
    for g in range(n_shared_applications(cfg)):
        sp = params.shared[g % copies]
        cache_kv = (cache["k"][g], cache["v"][g]) if decode else None
        h, (nk, nv) = _shared_apply(h, sp, cfg, rope=rope, mode=mode,
                                    cache_kv=cache_kv, lengths=lengths,
                                    impl=attn_impl, kv_valid=kv_valid)
        if not decode:
            computed_k.append(nk)
            computed_v.append(nv)
        for i in range(g * every, min((g + 1) * every, cfg.n_layers)):
            states = ({"conv_state": (cache["conv_x"][i], cache["conv_bc"][i]),
                       "ssm_state": cache["ssm"][i]} if decode else {})
            h, (cx, cbc), ssm = mamba_block(h, params.layers[i], cfg, mode=mode,
                                            impl=attn_impl, **states)
            h = constrain(h, ("batch", "seq", "embed"))
            for key, t in zip(STATES, (cx, cbc, ssm)):
                if decode:
                    cache[key][i] = t
                else:
                    new[key].append(t)
    if decode:
        return h, {**cache, "lengths": lengths + 1}
    return h, {"computed_k": torch.stack(computed_k),
               "computed_v": torch.stack(computed_v),
               **{key: torch.stack(v) for key, v in new.items()}}


def write_prefill_to_zamba_cache(cache: Dict, rows, pre: Dict,
                                 prefill_len: int) -> None:
    """Write a prefill's K/V (ring-aware) and all three states into
    ``cache`` rows ``rows`` in place, each cast to the cache's dtype (as the
    reference's cache insertion casts), and set their lengths. Every state
    of the rows is overwritten, so a reused slot starts clean."""
    write_prefill_to_cache(cache, rows, pre["computed_k"], pre["computed_v"],
                           prefill_len)
    for key in STATES:
        cache[key][:, rows] = pre[key].to(cache[key].dtype)


def fill_zamba_cache_from_prefill(cfg: ModelConfig, pre: Dict, prefill_len,
                                  max_len: int, batch: int,
                                  dtype=torch.bfloat16) -> Dict:
    """A decode cache from prefill outputs: K/V in ``dtype`` in the ring,
    the states as the prefill computed them; each row's length
    ``prefill_len`` (an int or (B,))."""
    cache = fill_cache_from_prefill(cfg, pre["computed_k"], pre["computed_v"],
                                    prefill_len, max_len, dtype)
    return {**cache, **{key: pre[key] for key in STATES}}
