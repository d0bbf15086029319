"""RWKV6 "Finch" block: time-mix with data-dependent decay + channel-mix.

Counterpart of ``repro.models.rwkv``: token-shift LoRA mixers, low-rank
decay, per-channel bonus ``u``, per-head group norm, relu^2 channel-mix.
The recurrence goes through the ``gla_scan`` CUDA kernel on prefill when
``impl == "kernel"`` (its plain version on CPU tensors) and through the
plain chunked scan ``gla_chunked`` when ``impl == "einsum"``; decode is the
single-token ``gla_step`` (the reference has no kernel for it). Training
(``mode="train"``) takes ``gla_chunked`` whatever ``impl`` says, as the
reference does: neither the reference's Pallas scan nor the port's kernel
has a backward, so autograd differentiates the plain chunked scan.

The reference stacks the layers on a leading axis and runs them with
``lax.scan``; here they are an ``nn.ModuleList`` walked by a Python loop.
Projection matrices are stored in the dtype ``init_rwkv`` is given (the
compute dtype to serve, float32 masters to train) and cast to the compute
dtype on every use, as the reference casts its float32 masters; the
token-shift mixers, decay LoRA, ``w0``, ``u``, norms and shift/wkv states
stay float32, as the reference computes them.

Decode state per layer: time-mix shift (B, D), channel-mix shift (B, D),
wkv state (B, H, K, K), all float32.
"""
from __future__ import annotations

import functools
import math
from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed.axes import (add_to_stream, constrain,
                                          contract_whole)
# the package, not its function: the kernel's plain version imports
# models.linear_attention, so a name bound here at import would be circular
from repro_torch.kernels import gla_scan as gla_kernel
from repro_torch.models.layers import (NormParams, activation, as_param,
                                       dense_init, embed_init, layernorm,
                                       norm_params, project_heads,
                                       rematerialized,
                                       truncated_normal_init)
from repro_torch.models.linear_attention import gla_chunked_sharded, gla_step

MIX_NAMES = ("w", "k", "v", "r", "g")
GROUP_NORM_EPS = 64e-5   # RWKV's GroupNorm(H), not the LayerNorm default
IMPLS = ("kernel", "einsum", "auto")


class RWKVBlockParams(nn.Module):
    """One layer's time-mix and channel-mix weights, in the reference's
    shapes and names (``repro.models.rwkv.rwkv_block_params``)."""

    MATRICES = ("wr", "wk", "wv", "wg", "wo", "cm_key", "cm_value", "cm_recept")

    def __init__(self, **tensors: torch.Tensor):
        super().__init__()
        for name, t in tensors.items():
            setattr(self, name, as_param(t))


def rwkv_block_params(cfg: ModelConfig, generator: torch.Generator,
                      device: torch.device, dtype: torch.dtype) -> RWKVBlockParams:
    """Random weights with the reference's initializers and scales."""
    d, r = cfg.d_model, cfg.rwkv
    hd = r.head_dim
    H = d // hd
    sc = 1.0 / math.sqrt(d)
    tn = lambda shape, s, dt=torch.float32: truncated_normal_init(
        shape, s, generator, device, dt)
    f32 = dict(dtype=torch.float32, device=device)
    w0 = (-6.0 + 5.0 * (torch.arange(d, **f32) / max(d - 1, 1)) ** 0.9).reshape(H, hd)
    return RWKVBlockParams(
        wr=tn((d, H, hd), sc, dtype), wk=tn((d, H, hd), sc, dtype),
        wv=tn((d, H, hd), sc, dtype), wg=tn((d, H, hd), sc, dtype),
        wo=tn((H, hd, d), sc, dtype),
        maa_x=torch.zeros(d, **f32), maa=torch.zeros(5, d, **f32),
        mix_lora_a=tn((5, d, r.mix_lora), 0.01),
        mix_lora_b=tn((5, r.mix_lora, d), 0.01),
        w0=w0,
        decay_lora_a=tn((d, r.decay_lora), 0.01),
        decay_lora_b=tn((r.decay_lora, H, hd), 0.01),
        u=tn((H, hd), 0.3),
        ln_x_scale=torch.ones(H, hd, **f32), ln_x_bias=torch.zeros(H, hd, **f32),
        cm_mu_k=torch.full((d,), 0.5, **f32), cm_mu_r=torch.full((d,), 0.5, **f32),
        cm_key=dense_init(d, cfg.mlp.d_ff, generator, device, dtype),
        cm_value=dense_init(cfg.mlp.d_ff, d, generator, device, dtype),
        cm_recept=dense_init(d, d, generator, device, dtype))


class RWKVLayerParams(nn.Module):
    def __init__(self, ln1: NormParams, ln2: NormParams, block: RWKVBlockParams):
        super().__init__()
        self.ln1 = ln1
        self.ln2 = ln2
        self.block = block


class RWKVParams(nn.Module):
    """embed (V, D), ln0, per-layer modules, final norm, untied lm_head
    (V, D). ``embed`` and ``lm_head`` are in ``init_rwkv``'s dtype."""

    def __init__(self, embed, ln0: NormParams, layers: List[RWKVLayerParams],
                 final_norm: NormParams, lm_head):
        super().__init__()
        self.embed = as_param(embed)
        self.ln0 = ln0
        self.layers = nn.ModuleList(layers)
        self.final_norm = final_norm
        self.lm_head = as_param(lm_head)


def init_rwkv(cfg: ModelConfig, generator: torch.Generator,
              device: torch.device, dtype: torch.dtype) -> RWKVParams:
    d = cfg.d_model
    ln = lambda: norm_params(d, "layernorm", device)
    layers = [RWKVLayerParams(ln(), ln(), rwkv_block_params(cfg, generator,
                                                            device, dtype))
              for _ in range(cfg.n_layers)]
    embed = embed_init(cfg.vocab_size, d, generator, device, dtype)
    lm_head = embed_init(cfg.vocab_size, d, generator, device, dtype)
    return RWKVParams(embed, ln(), layers, ln(), lm_head)


def _group_norm_heads(x, scale, bias, eps: float = GROUP_NORM_EPS):
    """Per-head layernorm over head_dim (RWKV's GroupNorm(H)), in float32.
    x: (B, T, H, hd); scale/bias: (H, hd)."""
    return F.layer_norm(x.float(), (x.shape[-1],), eps=eps) * scale + bias


def _token_shift(x, shift_state: Optional[torch.Tensor]):
    """Returns the previous-token stream. x: (B,T,D); shift_state: (B,D)."""
    first = (torch.zeros_like(x[:, :1]) if shift_state is None
             else shift_state[:, None].to(x.dtype))
    return torch.cat([first, x[:, :-1]], dim=1)


def rwkv_time_mix(x, p: RWKVBlockParams, cfg: ModelConfig, *,
                  shift_state=None, wkv_state=None, mode: str = "prefill",
                  impl: str = "kernel"):
    """x: (B, T, D) in the compute dtype. Returns (out (B,T,D), new time-mix
    shift (B,D) float32, new wkv state (B,H,K,K) float32). Prefill and
    train start from zero states; decode reads ``shift_state`` and
    ``wkv_state``."""
    x = constrain(x, ("batch", "seq_inner", "embed"))   # the shift runs along seq
    dt = x.dtype
    xf = x.float()
    xx = _token_shift(xf, shift_state) - xf
    xxx = xf + xx * p.maa_x
    # 5 low-rank token-shift mixers: (B,T,5,D)
    mix = torch.einsum("btsr,srd->btsd",
                       torch.tanh(torch.einsum("btd,sdr->btsr", xxx, p.mix_lora_a)),
                       p.mix_lora_b)
    streams = {name: xf + xx * (p.maa[i] + mix[:, :, i])
               for i, name in enumerate(MIX_NAMES)}
    rr = project_heads(streams["r"].to(dt), p.wr)
    kk = project_heads(streams["k"].to(dt), p.wk)
    vv = project_heads(streams["v"].to(dt), p.wv)
    g = F.silu(project_heads(streams["g"].to(dt), p.wg))

    # data-dependent decay: log w = -exp(w0 + lora(wt)) in (-inf, 0), float32
    dlora = torch.einsum("btr,rhk->bthk", torch.tanh(streams["w"] @ p.decay_lora_a),
                         p.decay_lora_b)
    log_w = -torch.exp(torch.clamp(p.w0 + dlora, -20.0, 10.0))

    if mode == "decode":
        o, new_state = gla_step(rr[:, 0], kk[:, 0], vv[:, 0], log_w[:, 0],
                                wkv_state, u=p.u, mode="rwkv")
        o = o[:, None]  # (B,1,H,V)
    elif impl == "kernel" and mode != "train":   # prefill scans from zero
        o, new_state = gla_kernel.gla_scan(rr, kk, vv, log_w, u=p.u, mode="rwkv")
    else:
        o, new_state = gla_chunked_sharded(rr, kk, vv, log_w, u=p.u, mode="rwkv")
    o = _group_norm_heads(o, p.ln_x_scale, p.ln_x_bias)
    y = (o.to(dt) * g).flatten(2)
    out = contract_whole(lambda y, w: y @ w.reshape(-1, w.shape[-1]), y, p.wo,
                         dims=(0, 1))
    return out, xf[:, -1], new_state


def rwkv_channel_mix(x, p: RWKVBlockParams, cfg: ModelConfig, *,
                     shift_state=None):
    x = constrain(x, ("batch", "seq_inner", "embed"))   # the shift runs along seq
    dt = x.dtype
    xf = x.float()
    xx = _token_shift(xf, shift_state) - xf
    xk = (xf + xx * p.cm_mu_k).to(dt)
    xr = (xf + xx * p.cm_mu_r).to(dt)
    k = activation(xk @ p.cm_key.to(dt), cfg.mlp.activation)
    out = torch.sigmoid(xr @ p.cm_recept.to(dt)) * contract_whole(
        torch.matmul, k, p.cm_value)
    return out, xf[:, -1]


def rwkv_state_shapes(cfg: ModelConfig, batch: int) -> Dict[str, Tuple[int, ...]]:
    d = cfg.d_model
    K = cfg.rwkv.head_dim
    return {"tm_shift": (cfg.n_layers, batch, d),
            "cm_shift": (cfg.n_layers, batch, d),
            "wkv": (cfg.n_layers, batch, d // K, K, K)}


def init_rwkv_cache(cfg: ModelConfig, batch: int, device) -> Dict:
    cache = {k: torch.zeros(s, dtype=torch.float32, device=device)
             for k, s in rwkv_state_shapes(cfg, batch).items()}
    cache["lengths"] = torch.zeros(batch, dtype=torch.int32, device=device)
    return cache


def _train_layer(h, lp: RWKVLayerParams, cfg: ModelConfig):
    out, _, _ = rwkv_time_mix(layernorm(h, lp.ln1.scale, lp.ln1.bias),
                              lp.block, cfg, mode="train")
    h = add_to_stream(h, out)
    out, _ = rwkv_channel_mix(layernorm(h, lp.ln2.scale, lp.ln2.bias),
                              lp.block, cfg)
    return constrain(add_to_stream(h, out), ("batch", "seq", "embed"))


def rwkv_forward(params: RWKVParams, cfg: ModelConfig, x, *,
                 mode: str = "prefill", cache: Optional[Dict] = None,
                 impl: str = "kernel", remat: bool = False,
                 remat_policy: str = "minimal"):
    """x: (B, S, D) embeddings (ln0 is applied here). Returns
    (hidden (B,S,D), states).

    prefill: scans from zero states and returns the new ones stacked over
    layers as ``{"tm_shift", "cm_shift", "wkv"}``. decode: reads ``cache``
    and writes its three states in place (``states`` is then ``cache``).
    train: scans from zero states through ``gla_chunked`` and returns the
    aux loss, 0, in place of states; with ``remat`` each layer is
    rematerialised under ``remat_policy``."""
    if impl not in IMPLS:
        raise ValueError(f"unknown impl {impl!r}")
    decode = mode == "decode"
    h = layernorm(x, params.ln0.scale, params.ln0.bias)
    if mode == "train":
        for lp in params.layers:
            layer = functools.partial(_train_layer, lp=lp, cfg=cfg)
            h = (rematerialized(layer, remat_policy) if remat else layer)(h)
        return h, torch.zeros((), dtype=torch.float32, device=h.device)
    new = {"tm_shift": [], "cm_shift": [], "wkv": []}
    for i, lp in enumerate(params.layers):
        hn = layernorm(h, lp.ln1.scale, lp.ln1.bias)
        out, tm, wkv = rwkv_time_mix(
            hn, lp.block, cfg, mode=mode, impl=impl,
            shift_state=cache["tm_shift"][i] if decode else None,
            wkv_state=cache["wkv"][i] if decode else None)
        h = add_to_stream(h, out)
        hn = layernorm(h, lp.ln2.scale, lp.ln2.bias)
        out, cm = rwkv_channel_mix(
            hn, lp.block, cfg,
            shift_state=cache["cm_shift"][i] if decode else None)
        h = constrain(add_to_stream(h, out), ("batch", "seq", "embed"))
        if decode:
            cache["tm_shift"][i] = tm
            cache["cm_shift"][i] = cm
            cache["wkv"][i] = wkv
        else:
            new["tm_shift"].append(tm)
            new["cm_shift"].append(cm)
            new["wkv"].append(wkv)
    if decode:
        return h, cache
    return h, {k: torch.stack(v) for k, v in new.items()}


def cache_from_states(states: Dict, prefill_len) -> Dict:
    """A fresh decode cache of prefill states (float32, as
    ``init_rwkv_cache``'s), each row's length ``prefill_len`` (an int or
    (B,))."""
    cache = {k: states[k].float() for k in ("tm_shift", "cm_shift", "wkv")}
    lengths = torch.zeros(cache["wkv"].shape[1], dtype=torch.int32,
                          device=cache["wkv"].device)
    lengths[:] = prefill_len
    return {**cache, "lengths": lengths}


def write_states(cache: Dict, rows, states: Dict, prefill_len: int) -> None:
    """Write prefill states (L, b, ...) into ``cache`` rows ``rows`` in place,
    all three of them (so a reused slot starts clean), and set their
    lengths."""
    for k in ("tm_shift", "cm_shift", "wkv"):
        cache[k][:, rows] = states[k]
    cache["lengths"][rows] = prefill_len


def rwkv_logits(params: RWKVParams, h: torch.Tensor) -> torch.Tensor:
    """Final LayerNorm and the untied LM head."""
    h = layernorm(h, params.final_norm.scale, params.final_norm.bias)
    h = constrain(h, ("batch", "seq_inner", "embed"))   # as tf.lm_logits
    return h @ params.lm_head.to(h.dtype).T
