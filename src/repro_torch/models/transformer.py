"""Transformer stacks: the dense, MoE, VLM and audio families.

Counterpart of ``repro.models.transformer``. The reference stacks layers on
a leading axis and runs them with ``lax.scan``; here the layers are an
``nn.ModuleList`` walked by a Python loop. A layer holds ``moe`` params in
place of ``mlp`` for the MoE family (``repro_torch.models.moe``); the VLM
(Qwen2-VL: M-RoPE, QKV bias, tied head) and audio (HuBERT: non-causal,
LayerNorm, an encoder without decode) families take frame or patch
embeddings in place of tokens (``embed_stub``) and otherwise share the
dense stack. RWKV6 and Zamba2 have their own stacks
(``repro_torch.models.rwkv``, ``repro_torch.models.zamba``). The
reference's sharding constraints (``distributed.axes.constrain``) sit where
the reference's do: no-ops outside an axis env. Training (``mode="train"``) returns the MoE aux
loss and can rematerialise each layer (``remat``), as the reference's
``jax.checkpoint`` of its scan body.
"""
from __future__ import annotations

import functools
from typing import Dict, Optional

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed.axes import add_to_stream, constrain, on_local
from repro_torch.models import attention as attn
from repro_torch.models.layers import (apply_mlp, apply_norm, as_param,
                                       embed_init, mlp_params, norm_params,
                                       rematerialized)
from repro_torch.models.moe import apply_moe, moe_params

FAMILIES = ("dense", "moe", "vlm", "audio")


def compute_dtype(cfg: ModelConfig) -> torch.dtype:
    return torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32


def check_supported(cfg: ModelConfig) -> None:
    if cfg.family not in FAMILIES:
        raise NotImplementedError(
            f"{cfg.name}: family {cfg.family!r} has no transformer stack; "
            f"this one builds {', '.join(FAMILIES)}")


class LayerParams(nn.Module):
    """One layer: ``mlp`` (dense, VLM, audio) or ``moe`` (MoE family)."""

    def __init__(self, attn_norm, attn_p, mlp_norm, mlp=None, moe=None):
        super().__init__()
        self.attn_norm = attn_norm
        self.attn = attn_p
        self.mlp_norm = mlp_norm
        self.mlp = mlp
        self.moe = moe


class TransformerParams(nn.Module):
    """embed (V, D), lm_head (V, D) unless tied, per-layer modules, final norm.

    Matrices are stored in the dtype ``init`` is given: the compute dtype
    for serving (the reference keeps float32 masters and casts them on every
    use, which gives the same values), float32 masters for training, cast on
    every use as the reference's; norm scales stay float32."""

    def __init__(self, embed, lm_head, layers, final_norm):
        super().__init__()
        self.embed = as_param(embed)
        self.lm_head = as_param(lm_head) if lm_head is not None else None
        self.layers = nn.ModuleList(layers)
        self.final_norm = final_norm


def init_transformer(cfg: ModelConfig, generator: Optional[torch.Generator],
                     device: torch.device,
                     dtype: Optional[torch.dtype] = None) -> TransformerParams:
    """Random weights with the reference's initializers and scales, drawn
    from ``generator`` on ``device``; matrices in ``dtype`` (default: the
    compute dtype)."""
    check_supported(cfg)
    dt = compute_dtype(cfg) if dtype is None else dtype
    embed = embed_init(cfg.vocab_size, cfg.d_model, generator, device, dt)
    lm_head = (None if cfg.tie_embeddings else
               embed_init(cfg.vocab_size, cfg.d_model, generator, device, dt))

    def ffn():
        if cfg.family == "moe":
            return {"moe": moe_params(cfg.d_model, cfg.moe, generator, device, dt)}
        return {"mlp": mlp_params(cfg.d_model, cfg.mlp.d_ff, cfg.mlp.gated,
                                  generator, device, dt)}

    layers = [
        LayerParams(
            norm_params(cfg.d_model, cfg.norm, device),
            attn.attn_params(cfg.d_model, cfg.attention, generator, device, dt),
            norm_params(cfg.d_model, cfg.norm, device), **ffn())
        for _ in range(cfg.n_layers)]
    return TransformerParams(embed, lm_head, layers,
                             norm_params(cfg.d_model, cfg.norm, device))


def _layer_apply(x, lp: LayerParams, cfg: ModelConfig, *, rope, mode,
                 cache_kv, lengths, impl, kv_valid=None):
    h = apply_norm(x, lp.attn_norm, cfg.norm, cfg.norm_eps)
    h = constrain(h, ("batch", "seq_inner", "embed"))
    a_out, new_kv = attn.attention_block(
        h, lp.attn, cfg.attention, rope=rope, mode=mode,
        cache=cache_kv, lengths=lengths, kv_valid=kv_valid, impl=impl)
    x = add_to_stream(x, a_out)
    x = constrain(x, ("batch", "seq", "embed"))
    h = apply_norm(x, lp.mlp_norm, cfg.norm, cfg.norm_eps)
    h = constrain(h, ("batch", "seq_inner", "embed"))
    if cfg.family == "moe":
        # the aux loss trains the router; serving ignores it
        m_out, aux = apply_moe(h, lp.moe, cfg.moe,
                               act=cfg.mlp.activation if cfg.mlp else "silu")
    else:
        m_out, aux = apply_mlp(h, lp.mlp, cfg.mlp.activation, cfg.mlp.gated), None
    x = constrain(add_to_stream(x, m_out), ("batch", "seq", "embed"))
    return x, new_kv, aux


def _train_layer(x, lp: LayerParams, cfg: ModelConfig, rope, impl,
                 kv_valid=None):
    x, _, aux = _layer_apply(x, lp, cfg, rope=rope, mode="train",
                             cache_kv=None, lengths=None, impl=impl,
                             kv_valid=kv_valid)
    return x, aux


def transformer_forward(params: TransformerParams, cfg: ModelConfig, x, *,
                        positions, mode: str = "prefill",
                        cache: Optional[Dict] = None,
                        kv_valid: Optional[torch.Tensor] = None,
                        attn_impl: str = "kernel", remat: bool = False,
                        remat_policy: str = "minimal"):
    """x: (B, S, D) embeddings; positions (B|1, S), or (B, S, 3) under
    M-RoPE; kv_valid (B, S) the valid keys of a right-padded batch. Returns
    (hidden (B,S,D), new_cache).

    decode: ``cache`` k/v are updated in place and returned with
    ``lengths + 1``. prefill: returns the computed K/V stacked as
    (L, B, S, KV, D), as the reference does. train: the full sequence, no
    K/V, and the summed MoE aux loss (float32 scalar; 0 for the other
    families) in place of a cache; with ``remat`` each layer is
    rematerialised under ``remat_policy`` (``layers.rematerialized``). The
    encoder's forward is train mode under ``torch.no_grad``."""
    check_supported(cfg)
    lengths = cache["lengths"] if cache is not None else None
    rope = attn.positional_angles(cfg.attention, positions)
    if mode == "train":
        aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
        for lp in params.layers:
            layer = functools.partial(_train_layer, lp=lp, cfg=cfg, rope=rope,
                                      impl=attn_impl, kv_valid=kv_valid)
            if remat:
                layer = rematerialized(layer, remat_policy)
            x, aux = layer(x)
            if aux is not None:   # MoE layers
                aux_total = aux_total + aux
        return x, aux_total
    computed_k, computed_v = [], []
    for i, lp in enumerate(params.layers):
        cache_kv = (cache["k"][i], cache["v"][i]) if mode == "decode" else None
        x, (nk, nv), _ = _layer_apply(
            x, lp, cfg, rope=rope, mode=mode, cache_kv=cache_kv,
            lengths=lengths, impl=attn_impl, kv_valid=kv_valid)
        if mode == "prefill":
            computed_k.append(nk)
            computed_v.append(nv)
    new_cache = None
    if mode == "decode":
        new_cache = {"k": cache["k"], "v": cache["v"], "lengths": lengths + 1}
    elif mode == "prefill":
        new_cache = {"computed_k": torch.stack(computed_k),
                     "computed_v": torch.stack(computed_v)}
    return x, new_cache


def write_prefill_to_cache(cache: Dict, rows, computed_k, computed_v,
                           prefill_len: int) -> None:
    """Write prefill K/V (L, b, S, KV, D) into ``cache`` rows ``rows`` in
    place, ring-aware for sliding windows, and set their lengths.

    The reference rebuilds the whole cache on every insert
    (``fill_cache_from_prefill`` + ``ServingEngine._insert_cache``); the port
    writes only the positions the prompt fills."""
    S = computed_k.shape[2]
    W = cache["k"].shape[2]
    keep = min(S, W)
    slots = (torch.arange(keep, device=computed_k.device) + (S - keep)) % W
    cache["k"][:, rows, slots] = computed_k[:, :, S - keep:].to(cache["k"].dtype)
    cache["v"][:, rows, slots] = computed_v[:, :, S - keep:].to(cache["v"].dtype)
    cache["lengths"][rows] = prefill_len


def fill_cache_from_prefill(cfg: ModelConfig, computed_k, computed_v,
                            prefill_len, max_len: int,
                            dtype: Optional[torch.dtype] = None) -> Dict:
    """Build a decode cache from prefill-computed K/V (ring-aware for SWA),
    in ``dtype`` (default: the K/V's). Under a mesh each rank fills the
    ring of its batch and head shards."""
    L, B, S, KV, D = computed_k.shape

    def ring(ck, cv):
        cache = attn.init_kv_cache(L, ck.shape[1], cfg.attention, max_len,
                                   ck.device, dtype or ck.dtype)
        write_prefill_to_cache(cache, slice(None), ck, cv, S)
        return cache["k"], cache["v"]

    k, v = on_local(ring, computed_k, computed_v, keep=(1, 3, 4))
    lengths = torch.zeros(B, dtype=torch.int32, device=computed_k.device)
    lengths[:] = prefill_len
    return {"k": k, "v": v, "lengths": lengths}


def embed_tokens(params: TransformerParams, cfg: ModelConfig,
                 tokens: torch.Tensor) -> torch.Tensor:
    # a gather by row: under a mesh on each rank's rows of tokens, the table
    # whole (a DTensor has no rule for the gather's backward, index_put)
    e = on_local(lambda t, table: table[t], tokens, params.embed, whole=(1,))
    e = constrain(e, ("batch", "seq", "embed"))
    return e.to(compute_dtype(cfg))


def lm_logits(params: TransformerParams, cfg: ModelConfig,
              h: torch.Tensor) -> torch.Tensor:
    h = apply_norm(h, params.final_norm, cfg.norm, cfg.norm_eps)
    # whole sequences for the vocabulary product: a flattened (batch, seq)
    # cannot stay split along both (sequence parallelism)
    h = constrain(h, ("batch", "seq_inner", "embed"))
    head = params.embed if cfg.tie_embeddings else params.lm_head
    return constrain(h @ head.to(h.dtype).T, ("batch", "seq", "vocab"))
