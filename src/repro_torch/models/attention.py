"""Attention: training and prefill over the whole sequence, decode against
a KV cache.

Counterpart of ``repro.models.attention``. Parameters keep the reference's
per-head layouts — wq (D, H, Dh), wk/wv (D, KV, Dh), wo (H, Dh, D) — so
weights convert one to one. Two implementations:

  - ``einsum`` : materialized scores in float32 — the plain path;
  - ``kernel`` : the hand-written CUDA kernels of ``repro_torch.kernels``
                 (prefill ``flash_attention``, decode ``decode_attention``);
                 the counterpart of the reference's ``impl="pallas"``. On CPU
                 tensors their wrappers run the kernels' plain versions.
                 Training (``mode="train"`` with gradients on) goes through
                 ``FlashAttention``: the forward kernel with its log-sum-exp
                 and the backward kernels, the counterpart of the
                 reference's custom-VJP flash core (``attention_flash_xla``),
                 which keeps O(S) per layer for the backward.

The reference's chunked ``xla`` forward serves its dry-run and long
sequences; the port's ``kernel`` path takes its place.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
from torch import nn
from torch.distributed.tensor import DTensor, Shard

from repro_torch.configs.base import AttentionConfig
from repro_torch.distributed.axes import constrain, contract_whole, on_local
from repro_torch.kernels.decode_attention import decode_attention
from repro_torch.kernels.flash_attention import FlashAttention, flash_attention
from repro_torch.models.layers import (apply_rope, as_param, project_heads,
                                       rope_angles, truncated_normal_init)

NEG_INF = -1e30


class AttnParams(nn.Module):
    def __init__(self, wq, wk, wv, wo, bq=None, bk=None, bv=None):
        super().__init__()
        self.wq, self.wk, self.wv, self.wo = (as_param(w) for w in (wq, wk, wv, wo))
        self.bq, self.bk, self.bv = (as_param(b) if b is not None else None
                                     for b in (bq, bk, bv))


def attn_params(d_model: int, cfg: AttentionConfig, generator, device,
                dtype=torch.float32) -> AttnParams:
    s = 1.0 / math.sqrt(d_model)
    so = 1.0 / math.sqrt(cfg.q_dim)
    init = lambda shape, scale: truncated_normal_init(shape, scale, generator,
                                                      device, dtype)
    p = dict(
        wq=init((d_model, cfg.n_heads, cfg.head_dim), s),
        wk=init((d_model, cfg.n_kv_heads, cfg.head_dim), s),
        wv=init((d_model, cfg.n_kv_heads, cfg.head_dim), s),
        wo=init((cfg.n_heads, cfg.head_dim, d_model), so),
    )
    if cfg.qkv_bias:
        zeros = lambda *shape: torch.zeros(shape, dtype=torch.float32, device=device)
        p.update(bq=zeros(cfg.n_heads, cfg.head_dim),
                 bk=zeros(cfg.n_kv_heads, cfg.head_dim),
                 bv=zeros(cfg.n_kv_heads, cfg.head_dim))
    return AttnParams(**p)


def _project_qkv(x, p: AttnParams, cfg: AttentionConfig):
    q, k, v = (project_heads(x, w) for w in (p.wq, p.wk, p.wv))
    if cfg.qkv_bias:
        q = q + p.bq.to(x.dtype)
        k = k + p.bk.to(x.dtype)
        v = v + p.bv.to(x.dtype)
    if cfg.kv_repeat > 1:
        rep = lambda t: torch.repeat_interleave(t, cfg.kv_repeat, dim=2)
        k, v = on_local(rep, k), on_local(rep, v)
    # "seq_inner" is never sharded: under sequence parallelism (variant
    # "sp") the residual stream is seq-sharded but attention internals
    # operate on the gathered sequence (Megatron-SP AG/RS placement)
    q = constrain(q, ("batch", "seq_inner", "heads", "head_dim"))
    k = constrain(k, ("batch", "seq_inner", "kv_heads", "head_dim"))
    v = constrain(v, ("batch", "seq_inner", "kv_heads", "head_dim"))
    return q, k, v


def positional_angles(cfg: AttentionConfig, positions: torch.Tensor
                      ) -> Optional[torch.Tensor]:
    """The rotations ``attention_block`` takes for ``positions``: RoPE's
    from (B|1, S) positions, M-RoPE's from (B, S, 3) streams, None without
    rotary embeddings."""
    if cfg.rope == "none":
        return None
    # row by row: M-RoPE's (B, S, 3) streams are a batch-sharded DTensor
    # under a mesh
    return on_local(lambda pos: rope_angles(pos, cfg.head_dim, cfg.rope_pct,
                                            cfg.rope_theta,
                                            mrope=cfg.rope == "mrope"),
                    positions)


def _apply_positional(q, k, rope: Optional[torch.Tensor]):
    # a rotation pairs channels of one head at their global offsets: batch
    # and heads keep their shards, head_dim and seq are whole
    if rope is not None:
        q = on_local(apply_rope, q, rope, keep=(0, 2))
        k = on_local(apply_rope, k, rope, keep=(0, 2))
    return q, k


# ---------------------------------------------------------------------------
# Plain attention (materialized scores)
# ---------------------------------------------------------------------------

def attention_einsum(q, k, v, cfg: AttentionConfig, q_offset: int = 0):
    """q: (B,Sq,H,D), k/v: (B,Skv,KV_eff,D). Returns (B,Sq,H,D)."""
    B, Sq, H, D = q.shape
    Skv, KV = k.shape[1], k.shape[2]
    G = H // KV
    qg = q.reshape(B, Sq, KV, G, D)
    scores = torch.einsum("bskgd,btkd->bkgst", qg.float(), k.float()) \
        / math.sqrt(D)
    qpos = q_offset + torch.arange(Sq, device=q.device)[:, None]
    kpos = torch.arange(Skv, device=q.device)[None, :]
    mask = torch.ones((Sq, Skv), dtype=torch.bool, device=q.device)
    if cfg.causal:
        mask &= kpos <= qpos
    if cfg.sliding_window is not None:
        mask &= kpos > qpos - cfg.sliding_window
    scores = scores.masked_fill(~mask, NEG_INF)
    w = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgst,btkd->bskgd", w, v.float())
    return out.reshape(B, Sq, H, D).to(q.dtype)


def attention_decode(q, k_cache, v_cache, cfg: AttentionConfig,
                     lengths: torch.Tensor, window: Optional[int] = None):
    """q: (B,1,H,D); caches: (B,W,KV_eff,D); lengths: (B,) tokens already
    in cache (including the newly inserted one). Returns (B,1,H,D)."""
    B, W, KV, D = k_cache.shape
    H = q.shape[2]
    G = H // KV
    qg = q.reshape(B, KV, G, D)
    # bf16 products are exact in float32, so upcasting the operands matches
    # the reference's float32-accumulated mixed-precision dot
    s = torch.einsum("bkgd,btkd->bkgt", qg.float(), k_cache.float()) / math.sqrt(D)
    slot = torch.arange(W, device=q.device)[None, :]
    if window is None:
        mask = slot < lengths[:, None]
    else:
        # ring buffer: every slot valid once the cache has wrapped
        mask = slot < torch.clamp(lengths, max=W)[:, None]
    s = s.masked_fill(~mask[:, None, None, :], NEG_INF)
    w = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgt,btkd->bkgd", w.to(v_cache.dtype).float(),
                       v_cache.float())
    return out.reshape(B, 1, H, D).to(q.dtype)


# ---------------------------------------------------------------------------
# KV cache
# ---------------------------------------------------------------------------

def cache_window(cfg: AttentionConfig, max_len: int) -> int:
    if cfg.sliding_window is not None:
        return min(cfg.sliding_window, max_len)
    return max_len


def init_kv_cache(n_layers: int, batch: int, cfg: AttentionConfig,
                  max_len: int, device, dtype=torch.bfloat16) -> dict:
    """Layout (L, B, W, KV_eff, D), the reference's."""
    W = cache_window(cfg, max_len)
    shape = (n_layers, batch, W, cfg.n_kv_eff, cfg.head_dim)
    return {
        "k": torch.zeros(shape, dtype=dtype, device=device),
        "v": torch.zeros(shape, dtype=dtype, device=device),
        "lengths": torch.zeros(batch, dtype=torch.int32, device=device),
    }


def cache_insert_decode(cache_k, cache_v, k_new, v_new, lengths, window: int):
    """Insert one token per sequence at ring position ``lengths % window``.

    cache_k/v: (B,W,KV,D); k_new/v_new: (B,1,KV,D); lengths: (B,). The port
    writes into the cache in place (the reference returns updated copies)."""
    rows = torch.arange(cache_k.shape[0], device=cache_k.device)
    idx = (lengths % window).long()
    cache_k[rows, idx] = k_new[:, 0].to(cache_k.dtype)
    cache_v[rows, idx] = v_new[:, 0].to(cache_v.dtype)
    return cache_k, cache_v


def _kernel_dims(q, k, v) -> Tuple[int, ...]:
    """The dimensions of q, k, v (B, S, H|KV, D) that may stay sharded when
    attention runs on each rank's shard (``on_local``): the batch, and the
    heads when q and k/v are split alike over the same mesh dimensions
    (whole q heads and their kv heads on each rank). head_dim and seq are
    gathered: a kernel never sees a piece of a head or of the sequence."""
    if not isinstance(q, DTensor):
        return (0,)
    split = [i for i, p in enumerate(q.placements)
             if isinstance(p, Shard) and p.dim == 2]
    ways = math.prod(q.device_mesh.shape[i] for i in split)
    alike = all(
        [i for i, p in enumerate(t.placements)
         if isinstance(p, Shard) and p.dim == 2] == split for t in (k, v))
    if split and alike and q.shape[2] % ways == 0 and k.shape[2] % ways == 0:
        return (0, 2)
    return (0,)


# ---------------------------------------------------------------------------
# Full attention block
# ---------------------------------------------------------------------------

def attention_block(x, p: AttnParams, cfg: AttentionConfig, *,
                    rope: Optional[torch.Tensor],
                    mode: str = "prefill",
                    cache: Optional[Tuple] = None,
                    lengths: Optional[torch.Tensor] = None,
                    impl: str = "kernel"):
    """One attention application.

    rope: ``positional_angles`` of the tokens' positions (None without
    rotary embeddings). mode: "train"/"prefill" (full sequence, causal or
    not as ``cfg.causal`` says) or "decode" (one token w/ cache). cache
    (decode): (k_cache, v_cache) of shape (B,W,KV_eff,D).
    Returns (out (B,S,D), new_cache_kv or computed (k, v))."""
    if impl not in ("kernel", "einsum"):
        raise ValueError(f"unknown attention impl {impl!r}")
    q, k, v = _project_qkv(x, p, cfg)
    q, k = _apply_positional(q, k, rope)

    if mode == "decode":
        if cache is None or lengths is None:
            raise ValueError("decode needs a cache and lengths")
        ck, cv = cache
        W = ck.shape[1]
        window = cfg.sliding_window
        ck, cv = cache_insert_decode(ck, cv, k, v, lengths, W)
        if impl == "kernel":
            out = decode_attention(q, ck, cv, lengths + 1, window=window)
        else:
            out = attention_decode(q, ck, cv, cfg, lengths + 1, window=window)
        new_cache = (ck, cv)
    else:
        if impl == "kernel" and mode == "train" and torch.is_grad_enabled():
            run = lambda q, k, v: FlashAttention.apply(q, k, v, cfg.causal,
                                                       cfg.sliding_window)
        elif impl == "kernel":
            run = lambda q, k, v: flash_attention(q, k, v, causal=cfg.causal,
                                                  window=cfg.sliding_window)
        else:
            run = lambda q, k, v: attention_einsum(q, k, v, cfg)
        out = on_local(run, q, k, v, keep=_kernel_dims(q, k, v))
        new_cache = (k, v)

    out = constrain(out, ("batch", "seq_inner", "heads", "head_dim"))
    H, Dh, D = p.wo.shape
    proj = contract_whole(lambda o, w: o.reshape(*o.shape[:-2], H * Dh)
                          @ w.reshape(H * Dh, D), out, p.wo, dims=(0, 1))
    return proj, new_cache
