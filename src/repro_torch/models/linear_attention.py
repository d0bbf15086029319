"""Generalized gated linear attention (GLA) recurrence.

Counterpart of ``repro.models.linear_attention``. Covers RWKV6 (per-channel
data-dependent decay + current-token bonus) and Mamba2/SSD (inclusive
current token):

    S_t = Diag(w_t) S_{t-1} + k_t v_t^T          state S: (K, V)
    rwkv:  o_t = q_t^T (S_{t-1} + Diag(u) k_t v_t^T)
    ssd:   o_t = q_t^T S_t

``gla_chunked`` is the chunked formulation the ``gla_scan`` kernel
implements (the plain ``"einsum"`` path of the model); ``gla_reference`` is
the token-by-token oracle; ``gla_step`` is the single-token decode step,
which has no kernel. The reference's ``lax.scan`` loops are Python loops.
All state and products are float32.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.distributed.axes import on_local


def gla_step(q, k, v, log_w, state, u: Optional[torch.Tensor] = None,
             mode: str = "ssd"):
    """Single-token decode step; under a mesh (``DTensor`` inputs) on each
    rank's (batch, head) shards.

    q/k/log_w: (B, H, K); v: (B, H, V); state: (B, H, K, V) float32;
    u: (H, K) bonus (rwkv) or None. Returns (o (B,H,V), new_state)."""
    if mode == "rwkv" and u is None:
        raise ValueError("mode 'rwkv' needs the bonus u")

    def step(q, k, v, log_w, state, *u):
        w = torch.exp(log_w.float())
        kv = k.float()[..., :, None] * v.float()[..., None, :]
        if mode == "rwkv":
            eff = state + u[0][0].float()[None, :, :, None] * kv
            o = torch.einsum("bhk,bhkv->bhv", q.float(), eff)
            new_state = w[..., None] * state + kv
        else:
            new_state = w[..., None] * state + kv
            o = torch.einsum("bhk,bhkv->bhv", q.float(), new_state)
        return o.to(v.dtype), new_state

    args = (q, k, v, log_w, state) + (() if u is None else (u[None],))
    return on_local(step, *args, keep=(0, 1))


def gla_chunked(q, k, v, log_w, u: Optional[torch.Tensor] = None,
                mode: str = "ssd", chunk: int = 32,
                initial_state: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunked parallel scan.

    q/k/log_w: (B, T, H, K); v: (B, T, H, V); u: (H, K) or None.
    Returns (o (B, T, H, V), final_state (B, H, K, V) float32).
    """
    B, T, H, K = q.shape
    V = v.shape[-1]
    chunk = min(chunk, T)
    pad = (-T) % chunk
    n = (T + pad) // chunk

    def to_chunks(x):  # (B, T, H, ·) -> (n, B, H, c, ·), zero-padded
        x = torch.nn.functional.pad(x.float(), (0, 0, 0, 0, 0, pad))
        return x.reshape(B, n, chunk, H, -1).permute(1, 0, 3, 2, 4)

    # log w = 0 -> w = 1 for padding (no decay)
    qc, kc, vc, lwc = map(to_chunks, (q, k, v, log_w))
    t_idx = torch.arange(chunk, device=q.device)
    mask = (t_idx[:, None] > t_idx[None, :]) if mode == "rwkv" \
        else (t_idx[:, None] >= t_idx[None, :])
    if mode == "rwkv" and u is None:
        raise ValueError("mode 'rwkv' needs the bonus u")
    state = (torch.zeros((B, H, K, V), dtype=torch.float32, device=q.device)
             if initial_state is None else initial_state.float())
    # causal pairs (t, j) and their decay exponents: every exponent is a sum
    # of log decays over the tokens it spans, formed directly, never as the
    # difference of two chunk-wide cumulative sums. Under RWKV6's floor
    # (-exp(10) per token) such sums reach ~1e6 within a chunk, where a
    # float32 ulp is 0.06, so a difference of two of them is off by whole
    # percents; a sum of same-signed terms keeps its relative accuracy.
    # Everything but the state's recurrence is computed for all chunks at
    # once (leading axis n); only the state runs chunk after chunk.
    after = (t_idx[:, None] > t_idx[None, :])[:, :, None]
    L = torch.cumsum(lwc, dim=3)              # cumulative log decay incl. t
    Lc = L[..., -1:, :]                       # total chunk decay
    # rwkv: decay applied to the state BEFORE reading at t, the exclusive
    # prefix as a shifted cumsum
    L_read = (torch.nn.functional.pad(L[..., :-1, :], (0, 0, 1, 0))
              if mode == "rwkv" else L)
    # intra-chunk: D[t, j] = sum of log w over j < i <= t, a cumsum along t
    # of the decays past j; rwkv reads D[t - 1, j]. Masked pairs are -inf
    # before exp.
    span = torch.cumsum(torch.where(after, lwc[..., :, None, :], 0.0), dim=3)
    if mode == "rwkv":
        span = torch.nn.functional.pad(span[..., :-1, :, :], (0, 0, 0, 0, 1, 0))
    diff = span.masked_fill(~mask[:, :, None], float("-inf"))
    att = torch.einsum("nbhck,nbhjk,nbhcjk->nbhcj", qc, kc, torch.exp(diff))
    o_intra = torch.einsum("nbhcj,nbhjv->nbhcv", att, vc)
    if mode == "rwkv":
        bonus = torch.einsum("nbhck,nbhck->nbhc", qc * u.float()[None, :, None, :],
                             kc)
        o_intra = o_intra + bonus[..., None] * vc
    # S_new = Diag(exp(Lc)) S + sum_j (k_j exp(sum of log w past j)) v_j,
    # the exclusive suffix sum again a sum, not Lc - L_j
    suffix = torch.flip(torch.cumsum(torch.flip(lwc, [3]), dim=3), [3])
    suffix = torch.nn.functional.pad(suffix[..., 1:, :], (0, 0, 0, 1))
    s_upd = torch.einsum("nbhck,nbhcv->nbhkv", kc * torch.exp(suffix), vc)
    decay = torch.exp(Lc).transpose(3, 4)     # (n, B, H, K, 1)
    before = []                               # the state each chunk reads
    for i in range(n):
        before.append(state)
        state = decay[i] * state + s_upd[i]
    o_inter = torch.einsum("nbhck,nbhkv->nbhcv", qc * torch.exp(L_read),
                           torch.stack(before))
    o = (o_inter + o_intra).permute(1, 0, 3, 2, 4).reshape(B, T + pad, H, V)
    return o[:, :T].to(v.dtype), state


def gla_reference(q, k, v, log_w, u: Optional[torch.Tensor] = None,
                  mode: str = "ssd",
                  initial_state: Optional[torch.Tensor] = None):
    """Token-by-token scan oracle (slow, exact).

    Model layout (B, T, H, ·); returns (o (B, T, H, V), final_state)."""
    B, T, H, K = q.shape
    V = v.shape[-1]
    state = (torch.zeros((B, H, K, V), dtype=torch.float32, device=q.device)
             if initial_state is None else initial_state.float())
    outs = []
    for t in range(T):
        o, state = gla_step(q[:, t], k[:, t], v[:, t], log_w[:, t], state,
                            u=u, mode=mode)
        outs.append(o)
    return torch.stack(outs, dim=1), state


def gla_chunked_sharded(q, k, v, log_w, u: Optional[torch.Tensor] = None,
                        mode: str = "rwkv"):
    """``gla_chunked`` from a zero state; under a mesh (``DTensor``
    inputs) on each rank's (batch, head) shards, since the scan treats every
    (row, head) on its own. Returns (o, final_state) as ``gla_chunked``."""
    def scan(q, k, v, log_w, *u):
        o, state = gla_chunked(q, k, v, log_w, u=u[0][0, 0] if u else None,
                               mode=mode)
        return o, state.transpose(1, 2)   # heads at dim 2, as the inputs'
    args = (q, k, v, log_w) + (() if u is None else (u[None, None],))
    o, state = on_local(scan, *args, keep=(0, 2))
    return o, state.transpose(1, 2)
