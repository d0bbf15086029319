"""Attention: training and prefill over the whole sequence, decode against
a KV cache.

Counterpart of ``repro.models.attention``. Parameters keep the reference's
per-head layouts — wq (D, H, Dh), wk/wv (D, KV, Dh), wo (H, Dh, D) — so
weights convert one to one. Three implementations:

  - ``einsum`` : materialized scores in float32 — the plain path;
  - ``auto``   : the reference's rule: ``einsum`` while S x Skv <= 256 x
                 256, else the chunked online softmax
                 (``attention_flash_xla``: 512-query by 1024-key chunks in
                 plain torch, its training form ``FlashCore`` saving the
                 output and log-sum-exp and recomputing P chunk by chunk in
                 the backward), the reference's ``xla`` path; decode is the
                 plain ``attention_decode``. ``auto`` launches no kernel, as
                 the reference's never reaches Pallas: it is the path the
                 dry-run traces;
  - ``kernel`` : the hand-written CUDA kernels of ``repro_torch.kernels``
                 (prefill ``flash_attention``, decode ``decode_attention``);
                 the counterpart of the reference's ``impl="pallas"``. On CPU
                 tensors their wrappers run the kernels' plain versions.
                 Training (``mode="train"`` with gradients on) goes through
                 ``FlashAttention``: the forward kernel with its log-sum-exp
                 and the backward kernels, the counterpart of the
                 reference's custom-VJP flash core (``attention_flash_xla``),
                 which keeps O(S) per layer for the backward.

A right-padded batch passes ``kv_valid`` (B, Skv), True at the keys of each
row's valid positions, to ``einsum`` and the chunked path. The flash kernel
takes no such mask: under a causal mask right padding never reaches a valid
query, so ``kernel`` runs unchanged there, and raises on a non-causal
config (the reference's Pallas branch drops the mask and would give padded
keys weight).
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
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

def attention_einsum(q, k, v, cfg: AttentionConfig, q_offset: int = 0,
                     kv_valid: Optional[torch.Tensor] = None):
    """q: (B,Sq,H,D), k/v: (B,Skv,KV_eff,D); kv_valid (B,Skv) masks padded
    keys. Returns (B,Sq,H,D)."""
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
    if kv_valid is not None:  # (B, Skv) padding mask
        scores = scores.masked_fill(~kv_valid[:, None, None, None, :], NEG_INF)
    w = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgst,btkd->bskgd", w, v.float())
    return out.reshape(B, Sq, H, D).to(q.dtype)


# ---------------------------------------------------------------------------
# Chunked flash-style attention (plain torch): the reference's ``xla`` path
#
# The forward is an online softmax over kv chunks; the backward (FlashCore)
# saves only (q, k, v, out, lse) and recomputes the score blocks chunk by
# chunk, so neither direction materializes S x S scores. The reference
# maps over q chunks (lax.map) and scans kv chunks (lax.scan); here both are
# Python loops, every chunk traced as it runs.
# ---------------------------------------------------------------------------

def _flash_mask(cfg: AttentionConfig, qpos, kpos, seq_q: int, seq_k: int):
    pm = (qpos[:, None] < seq_q) & (kpos[None, :] < seq_k)
    if cfg.causal:
        pm &= kpos[None, :] <= qpos[:, None]
    if cfg.sliding_window is not None:
        pm &= kpos[None, :] > qpos[:, None] - cfg.sliding_window
    return pm


# Layouts inside the loops: a q chunk's G query heads of a kv head are
# folded into its rows and (B, KV) into one batch, (B*KV, G*cq, D), so each
# chunk product is one bmm against a kv chunk, (B*KV, ck, D) (v, and k for
# dq) or (B*KV, D, ck) (k for the scores).

def _kv_chunks(x, transpose: bool = False):
    """(B, nk, ck, KV, D) -> float32 (nk, B*KV, ck, D), or (nk, B*KV, D, ck)
    when ``transpose``; contiguous."""
    B, nk, ck, KV, D = x.shape
    x = x.float().permute(1, 0, 3, 2, 4)
    if transpose:
        x = x.transpose(-1, -2)
    return x.reshape(nk, B * KV, *x.shape[-2:]).contiguous()


def _q_rows(x):
    """A q chunk (B, cq, KV, G, D) -> float32 (B*KV, G*cq, D)."""
    B, cq, KV, G, D = x.shape
    return x.float().permute(0, 2, 3, 1, 4).reshape(B * KV, G * cq, D)


def _online_softmax(qf, kt, vc, blocked, shape, scale):
    """One q chunk's rows qf (B*KV, G*cq, D) against kv chunks kt (each
    (B*KV, D, ck)) and vc (each (B*KV, ck, D)), chunk ki masked where
    ``blocked[ki]`` ((cq, ck) or broadcastable to (B,1,1,cq,ck)) is True;
    ``shape`` is (B, KV, G, cq). Returns (out (B,cq,KV,G,D) float32, lse
    (B,KV,G,cq))."""
    D = qf.shape[-1]
    m = torch.full((*shape, 1), NEG_INF, dtype=torch.float32, device=qf.device)
    l = torch.zeros_like(m)
    acc = torch.zeros((*shape, D), dtype=torch.float32, device=qf.device)
    for k_t, v_c, off in zip(kt, vc, blocked):
        s = torch.bmm(qf, k_t) * scale
        s = s.view(*shape, -1).masked_fill(off, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new)
        l = l * alpha + p.sum(dim=-1, keepdim=True)
        pv = torch.bmm(p.view(qf.shape[0], qf.shape[1], -1), v_c)
        acc = acc * alpha + pv.view(*shape, D)
        m = m_new
    out = acc / torch.clamp(l, min=1e-37)
    lse = (m + torch.log(torch.clamp(l, min=1e-37)))[..., 0]
    return out.permute(0, 3, 1, 2, 4), lse


def _blocked(cfg, qi, cq, nk, ck, seq_q, seq_k, device):
    """The masked pairs of q chunk ``qi`` against each kv chunk: one mask a
    q chunk, split into the kv chunks' (cq, ck) views."""
    qpos = qi * cq + torch.arange(cq, device=device)
    off = ~_flash_mask(cfg, qpos, torch.arange(nk * ck, device=device),
                       seq_q, seq_k)
    return off.split(ck, dim=1)


def _flash_fwd_padded(q, k, v, cfg, seq_q: int, seq_k: int):
    """q: (B,nq,cq,KV,G,D) chunked; k/v: (B,nk,ck,KV,D). Returns
    (out (B,nq,cq,KV,G,D) float32, lse (B,nq,KV,G,cq))."""
    B, nq, cq, KV, G, D = q.shape
    nk, ck = k.shape[1], k.shape[2]
    kt, vc = _kv_chunks(k, transpose=True).unbind(), _kv_chunks(v).unbind()
    outs, lses = [], []
    for qi in range(nq):
        out, lse = _online_softmax(
            _q_rows(q[:, qi]), kt, vc,
            _blocked(cfg, qi, cq, nk, ck, seq_q, seq_k, q.device),
            (B, KV, G, cq), 1.0 / math.sqrt(D))
        outs.append(out)
        lses.append(lse)
    return torch.stack(outs, dim=1), torch.stack(lses, dim=1)


def _flash_bwd_padded(cfg, seq_q: int, seq_k: int, q, k, v, out, lse, dout):
    """dq, dk, dv of the chunked forward, recomputing P from lse chunk by
    chunk; dk and dv accumulate in float32."""
    B, nq, cq, KV, G, D = q.shape
    nk, ck = k.shape[1], k.shape[2]
    shape, rows = (B, KV, G, cq), G * cq
    scale = 1.0 / math.sqrt(D)
    do = dout.float()
    delta = (do * out.float()).sum(dim=-1)            # (B,nq,cq,KV,G)
    kc, kt = _kv_chunks(k).unbind(), _kv_chunks(k, transpose=True).unbind()
    vt = _kv_chunks(v, transpose=True).unbind()
    dk = torch.zeros((nk, B * KV, ck, D), dtype=torch.float32, device=q.device)
    dv = torch.zeros_like(dk)
    dqs = []
    for qi in range(nq):
        blocked = _blocked(cfg, qi, cq, nk, ck, seq_q, seq_k, q.device)
        qf, dof = _q_rows(q[:, qi]), _q_rows(do[:, qi])
        lse_blk = lse[:, qi]                          # (B,KV,G,cq)
        del_t = delta[:, qi].permute(0, 2, 3, 1)      # (B,KV,G,cq)
        dq = torch.zeros((B * KV, rows, D), dtype=torch.float32, device=q.device)
        for ki in range(nk):
            s = torch.bmm(qf, kt[ki]) * scale
            s = s.view(*shape, ck).masked_fill(blocked[ki], NEG_INF)
            p = torch.exp(s - lse_blk[..., None])     # (B,KV,G,cq,ck)
            dp = torch.bmm(dof, vt[ki]).view(*shape, ck)
            ds = (p * (dp - del_t[..., None]) * scale).view(B * KV, rows, ck)
            dq = dq + torch.bmm(ds, kc[ki])
            dk[ki] += torch.bmm(ds.transpose(1, 2), qf)
            dv[ki] += torch.bmm(p.view(B * KV, rows, ck).transpose(1, 2), dof)
        dqs.append(dq.view(*shape, D).permute(0, 3, 1, 2, 4))
    back = lambda g, x: (g.view(nk, B, KV, ck, D).permute(1, 0, 3, 2, 4)
                         .to(x.dtype))
    return torch.stack(dqs, dim=1).to(q.dtype), back(dk, k), back(dv, v)


class FlashCore(torch.autograd.Function):
    """The chunked forward with the flash backward: the counterpart of the
    reference's ``_flash_core`` custom VJP. Saves (q, k, v, out, lse)."""

    @staticmethod
    def forward(ctx, q, k, v, cfg, seq_q, seq_k):
        out, lse = _flash_fwd_padded(q, k, v, cfg, seq_q, seq_k)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.args = (cfg, seq_q, seq_k)
        return out

    @staticmethod
    def backward(ctx, dout):
        return (*_flash_bwd_padded(*ctx.args, *ctx.saved_tensors, dout),
                None, None, None)


def _pad_seq(x, n: int):
    return F.pad(x, (0, 0) * (x.ndim - 2) + (0, n)) if n else x


def attention_flash_xla(q, k, v, cfg: AttentionConfig, q_offset: int = 0,
                        kv_valid: Optional[torch.Tensor] = None,
                        q_chunk: int = 512, kv_chunk: int = 1024):
    """Chunked flash attention in plain torch. q: (B,S,H,D); k/v:
    (B,S,KV_eff,D). Without ``kv_valid`` and offset (training, packed
    batches) through ``FlashCore``; a padding mask takes the varlen path
    (inference only), as the reference's."""
    if kv_valid is not None or q_offset != 0:
        return _attention_flash_xla_varlen(q, k, v, cfg, q_offset, kv_valid,
                                           q_chunk, kv_chunk)
    B, Sq, H, D = q.shape
    Skv, KV = k.shape[1], k.shape[2]
    G = H // KV
    cq, ck = min(q_chunk, Sq), min(kv_chunk, Skv)
    pq, pk = (-Sq) % cq, (-Skv) % ck
    qc = _pad_seq(q, pq).reshape(B, (Sq + pq) // cq, cq, KV, G, D)
    kc = _pad_seq(k, pk).reshape(B, (Skv + pk) // ck, ck, KV, D)
    vc = _pad_seq(v, pk).reshape(B, (Skv + pk) // ck, ck, KV, D)
    out = FlashCore.apply(qc, kc, vc, cfg, Sq, Skv)
    return out.reshape(B, Sq + pq, H, D)[:, :Sq].to(q.dtype)


def _attention_flash_xla_varlen(q, k, v, cfg: AttentionConfig, q_offset=0,
                                kv_valid: Optional[torch.Tensor] = None,
                                q_chunk: int = 512, kv_chunk: int = 1024):
    """Online-softmax attention over q chunks (outer) and kv chunks (inner)
    with a per-row key mask; memory per step O(q_chunk x kv_chunk)."""
    B, Sq, H, D = q.shape
    Skv, KV = k.shape[1], k.shape[2]
    G = H // KV
    cq, ck = min(q_chunk, Sq), min(kv_chunk, Skv)
    pq, pk = (-Sq) % cq, (-Skv) % ck
    valid = (torch.ones((B, Skv), dtype=torch.bool, device=q.device)
             if kv_valid is None else kv_valid)
    valid = F.pad(valid, (0, pk)) if pk else valid
    nq, nk = (Sq + pq) // cq, (Skv + pk) // ck
    qg = _pad_seq(q, pq).reshape(B, nq, cq, KV, G, D)
    kc = _pad_seq(k, pk).reshape(B, nk, ck, KV, D)
    vc = _pad_seq(v, pk).reshape(B, nk, ck, KV, D)
    kt, vc = _kv_chunks(kc, transpose=True).unbind(), _kv_chunks(vc).unbind()
    outs = []
    for qi in range(nq):
        qpos = q_offset + qi * cq + torch.arange(cq, device=q.device)
        # padded keys are invalid; padded queries are sliced off below
        off = ~(valid[:, None, None, None, :] & _flash_mask(
            cfg, qpos, torch.arange(nk * ck, device=q.device),
            q_offset + nq * cq, nk * ck))
        outs.append(_online_softmax(_q_rows(qg[:, qi]), kt, vc,
                                    off.split(ck, dim=-1), (B, KV, G, cq),
                                    1.0 / math.sqrt(D))[0])
    out = torch.stack(outs, dim=1).reshape(B, Sq + pq, H, D)
    return out[:, :Sq].to(q.dtype)


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
    writes into the cache in place (the reference returns updated copies).
    A ``DTensor`` cache is written on each rank's shards."""
    if isinstance(cache_k, DTensor):
        return _insert_on_shards(cache_k, cache_v, k_new, v_new, lengths,
                                 window)
    rows = torch.arange(cache_k.shape[0], device=cache_k.device)
    idx = (lengths % window).long()
    cache_k[rows, idx] = k_new[:, 0].to(cache_k.dtype)
    cache_v[rows, idx] = v_new[:, 0].to(cache_v.dtype)
    return cache_k, cache_v


def _insert_on_shards(cache_k, cache_v, k_new, v_new, lengths, window: int):
    """``cache_insert_decode`` on every rank's shards of a ``DTensor`` cache,
    in place: a rank whose slice of W (the long-context layout splits it)
    does not hold a row's ring position leaves that row as it was."""
    mesh = cache_k.device_mesh
    coord = mesh.get_coordinate()
    w0, w_local = 0, cache_k.shape[1]
    for i, p in enumerate(cache_k.placements):   # W split in mesh order
        if isinstance(p, Shard) and p.dim == 1:
            w_local //= mesh.shape[i]
            w0 += coord[i] * w_local

    def insert(ck, cv, kn, vn, ln):
        rows = torch.arange(ck.shape[0], device=ck.device)
        idx = (ln.reshape(-1) % window).long() - w0
        here = ((idx >= 0) & (idx < w_local))[:, None, None]
        idx = idx.clamp(0, w_local - 1)
        ck[rows, idx] = torch.where(here, kn[:, 0].to(ck.dtype), ck[rows, idx])
        cv[rows, idx] = torch.where(here, vn[:, 0].to(cv.dtype), cv[rows, idx])
        return ck, cv

    keep = tuple(p.dim for p in cache_k.placements if isinstance(p, Shard))
    return on_local(insert, cache_k, cache_v, k_new, v_new,
                    lengths[:, None, None, None], keep=keep)


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
                    kv_valid: Optional[torch.Tensor] = None,
                    impl: str = "kernel"):
    """One attention application.

    rope: ``positional_angles`` of the tokens' positions (None without
    rotary embeddings). mode: "train"/"prefill" (full sequence, causal or
    not as ``cfg.causal`` says) or "decode" (one token w/ cache). cache
    (decode): (k_cache, v_cache) of shape (B,W,KV_eff,D). kv_valid (B,S):
    the valid keys of a right-padded batch (a plain tensor).
    Returns (out (B,S,D), new_cache_kv or computed (k, v))."""
    if impl not in ("kernel", "einsum", "auto"):
        raise ValueError(f"unknown attention impl {impl!r}")
    if impl == "kernel" and kv_valid is not None and not cfg.causal:
        raise ValueError("the flash kernel takes no padding mask: a "
                         "non-causal model's padded batch needs "
                         "impl='einsum' or 'auto'")
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
            # under a mesh on each rank's batch (and head) shards
            out = on_local(
                lambda q, ck, cv, n: attention_decode(
                    q, ck, cv, cfg, n.reshape(-1) + 1, window=window),
                q, ck, cv, lengths[:, None, None, None],
                keep=_kernel_dims(q, ck, cv))
        new_cache = (ck, cv)
    else:
        if impl == "kernel" and mode == "train" and torch.is_grad_enabled():
            run = lambda q, k, v: FlashAttention.apply(q, k, v, cfg.causal,
                                                       cfg.sliding_window)
        elif impl == "kernel":
            # right padding never reaches a valid query under a causal mask
            run = lambda q, k, v: flash_attention(q, k, v, causal=cfg.causal,
                                                  window=cfg.sliding_window)
        elif impl == "einsum" or q.shape[1] * k.shape[1] <= 256 * 256:
            run = lambda q, k, v: attention_einsum(q, k, v, cfg,
                                                   kv_valid=kv_valid)
        else:
            run = lambda q, k, v: attention_flash_xla(q, k, v, cfg,
                                                      kv_valid=kv_valid)
        out = on_local(run, q, k, v, keep=_kernel_dims(q, k, v))
        new_cache = (k, v)

    out = constrain(out, ("batch", "seq_inner", "heads", "head_dim"))
    H, Dh, D = p.wo.shape
    proj = contract_whole(lambda o, w: o.reshape(*o.shape[:-2], H * Dh)
                          @ w.reshape(H * Dh, D), out, p.wo, dims=(0, 1))
    return proj, new_cache
