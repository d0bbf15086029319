"""Plain reference of the MoE transformer family (Qwen3-MoE, Mixtral).

Everything the benchmark knows of the family's mathematics, in plain
PyTorch and float32: the weights it draws (``draw``), the logits a served
sequence should get (``served_logits``), and the model FLOPs a prefill or a
decode step does (``prefill_flops``, ``decode_flops``). It imports nothing
of the program under test.

The layer, as the configuration states it: RMSNorm, attention (GQA, RoPE on
interleaved channel pairs, causal), a residual; RMSNorm, a router softmax
over the experts, the top k with their probabilities renormalised, each
expert a SiLU-gated MLP, the gate-weighted sum, a residual; after the last
layer RMSNorm and the output head. The experts dispatch with a capacity per
batch row, C = max(8, roundup8(ceil(k * S * capacity_factor / E))): in each
row the first C (token, choice) pairs routed to an expert, in token order,
are computed and the rest dropped. A served prompt is one row of its own,
and every later token is a row of its own (one token per row at decode).

``served_logits`` computes in blocks so that it fits beside the weights: a
layer's matrices are upcast to float32 one at a time, the experts one
expert at a time, attention one query block at a time.
"""
from __future__ import annotations

import math
from types import SimpleNamespace
from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

# std of a unit normal truncated at +-2 sigma, the port's initializer
TRUNC_STD = 0.8796256610342398
FP8_MAX = 448.0          # largest float8_e4m3fn


def dims(cfg: Dict) -> SimpleNamespace:
    """The sizes of a configuration file, under the family's own names."""
    H = cfg["num_attention_heads"]
    return SimpleNamespace(
        L=cfg["num_hidden_layers"], D=cfg["hidden_size"], H=H,
        KV=cfg["num_key_value_heads"],
        Dh=cfg.get("head_dim") or cfg["hidden_size"] // H,
        E=cfg.get("num_experts") or cfg["num_local_experts"],
        K=cfg["num_experts_per_tok"],
        F=cfg.get("moe_intermediate_size") or cfg["intermediate_size"],
        V=cfg["vocab_size"], eps=cfg["rms_norm_eps"],
        theta=cfg["rope_theta"], cf=cfg["capacity_factor"],
        window=cfg.get("sliding_window"))


def capacity(d: SimpleNamespace, tokens: int) -> int:
    c = math.ceil(d.K * tokens * d.cf / d.E)
    return max(8, -(-c // 8) * 8)


def draw(cfg: Dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """The weights, drawn from ``seed`` on ``device`` in bf16, each kind of
    matrix for every layer in one call: normal at the variance of the
    port's truncated-normal initializer. Norm scales are 1 (float32)."""
    d = dims(cfg)
    gen = torch.Generator(device=device).manual_seed(seed)

    def normal(shape, scale):
        return torch.randn(shape, generator=gen, device=device,
                           dtype=torch.bfloat16).mul_(scale * TRUNC_STD)

    ones = lambda *shape: torch.ones(shape, dtype=torch.float32, device=device)
    return {
        "embed": normal((d.V, d.D), 1.0),
        "lm_head": normal((d.V, d.D), 1.0),
        "wq": normal((d.L, d.D, d.H, d.Dh), d.D ** -0.5),
        "wk": normal((d.L, d.D, d.KV, d.Dh), d.D ** -0.5),
        "wv": normal((d.L, d.D, d.KV, d.Dh), d.D ** -0.5),
        "wo": normal((d.L, d.H, d.Dh, d.D), (d.H * d.Dh) ** -0.5),
        "router": normal((d.L, d.D, d.E), d.D ** -0.5),
        "up": normal((d.L, d.E, d.D, d.F), d.D ** -0.5),
        "gate": normal((d.L, d.E, d.D, d.F), d.D ** -0.5),
        "down": normal((d.L, d.E, d.F, d.D), d.F ** -0.5),
        "attn_norm": ones(d.L, d.D),
        "mlp_norm": ones(d.L, d.D),
        "final_norm": ones(d.D),
    }


# ---------------------------------------------------------------------------
# model FLOPs: what the model needs, not what a program computes
# ---------------------------------------------------------------------------

def token_flops(d: SimpleNamespace) -> int:
    """2 x the weights one token passes in one layer: the attention
    projections, the router and its top-k experts' three matrices."""
    proj = d.D * (d.H + 2 * d.KV) * d.Dh + d.H * d.Dh * d.D
    return 2 * (proj + d.D * d.E + d.K * 3 * d.D * d.F)


def attention_flops(d: SimpleNamespace, keys: int) -> int:
    """Scores and values of one query over ``keys`` keys, in one layer."""
    if d.window is not None:
        keys = min(keys, d.window)
    return 4 * d.Dh * d.H * keys


def prefill_flops(cfg: Dict, prompt: int) -> int:
    """A prompt of ``prompt`` tokens through every layer (each query sees
    the keys up to its own), and the output head once (its last token)."""
    d = dims(cfg)
    pairs = sum(attention_flops(d, q + 1) for q in range(prompt)) \
        if d.window is not None else 4 * d.Dh * d.H * prompt * (prompt + 1) // 2
    return d.L * (prompt * token_flops(d) + pairs) + 2 * d.D * d.V


def decode_flops(cfg: Dict, keys: Sequence[int]) -> int:
    """One decode step of the rows whose new token sees ``keys`` keys
    (itself included): every layer, and the output head for each row."""
    d = dims(cfg)
    per_row = d.L * token_flops(d) + 2 * d.D * d.V
    return len(keys) * per_row + d.L * sum(attention_flops(d, n) for n in keys)


# ---------------------------------------------------------------------------
# the served logits
# ---------------------------------------------------------------------------

def _fp8(x: torch.Tensor, dim) -> torch.Tensor:
    """x rounded to float8_e4m3fn with a scale per slice along ``dim``
    (amax to the format's largest), back in float32."""
    s = x.abs().amax(dim=dim, keepdim=True).clamp(min=1e-12) / FP8_MAX
    return (x / s).to(torch.float8_e4m3fn).float() * s


class _Precision:
    """float32 throughout, or (``fp8``) every matrix product's operands
    rounded to float8_e4m3fn: weights with one scale a matrix, activations
    one a row. The control that a program computing below its stated
    bf16 has to fail."""

    def __init__(self, fp8: bool):
        self.fp8 = fp8

    def weight(self, w: torch.Tensor) -> torch.Tensor:
        w = w.float()
        return _fp8(w, dim=tuple(range(w.ndim))) if self.fp8 else w

    def act(self, x: torch.Tensor) -> torch.Tensor:
        return _fp8(x, dim=-1) if self.fp8 else x


def _rmsnorm(x, scale, eps):
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * scale


def _rope(x, cos, sin):
    """Rotate the interleaved pairs (x[2j], x[2j+1]) of each head: x
    (T, h, Dh), cos/sin (T, 1, Dh/2)."""
    a, b = x[..., 0::2], x[..., 1::2]
    return torch.stack((a * cos - b * sin, b * cos + a * sin), -1).flatten(-2)


def _attention(q, k, v, d, block: int):
    """Causal GQA attention of one sequence: q (T, H, Dh), k/v (T, KV, Dh)
    -> (T, H*Dh), one block of queries at a time."""
    T = q.shape[0]
    G = d.H // d.KV
    kf = k.repeat_interleave(G, dim=1).transpose(0, 1)     # (H, T, Dh)
    vf = v.repeat_interleave(G, dim=1).transpose(0, 1)
    out = torch.empty((T, d.H, d.Dh), dtype=torch.float32, device=q.device)
    keys = torch.arange(T, device=q.device)
    for s in range(0, T, block):
        e = min(T, s + block)
        qb = q[s:e].transpose(0, 1)                          # (H, b, Dh)
        scores = qb @ kf[:, :e].transpose(1, 2) / math.sqrt(d.Dh)
        rows = torch.arange(s, e, device=q.device)[:, None]
        masked = keys[None, :e] > rows
        if d.window is not None:
            masked |= keys[None, :e] <= rows - d.window
        scores.masked_fill_(masked, float("-inf"))
        out[s:e] = (torch.softmax(scores, -1) @ vf[:, :e]).transpose(0, 1)
    return out.reshape(T, d.H * d.Dh)


def _keep(idx: torch.Tensor, row: torch.Tensor, d) -> torch.Tensor:
    """Which (token, choice) pairs the capacity keeps: ``idx`` (N, K) the
    experts, ``row`` (N,) the batch row of each token, in token order. A
    pair is kept while fewer than its row's capacity of the same row's
    earlier pairs (in token, then choice order) went to its expert."""
    N, K = idx.shape
    key = (row[:, None] * d.E + idx).reshape(-1)
    order = torch.argsort(key, stable=True)
    sk = key[order]
    first = torch.searchsorted(sk, sk, side="left")
    rank = torch.empty_like(order)
    rank[order] = torch.arange(N * K, device=idx.device) - first
    sizes = torch.bincount(row)
    caps = torch.tensor([capacity(d, int(n)) for n in sizes.tolist()],
                        device=idx.device)
    return (rank < caps[row].repeat_interleave(K)).reshape(N, K)


def _moe(h, row, W, l, d, p: _Precision):
    """The experts' gate-weighted output (N, D) of the normed tokens h."""
    logits = p.act(h) @ p.weight(W["router"][l])
    probs = torch.softmax(logits, -1)
    top, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gates, idx = top[:, :d.K], idx[:, :d.K]
    gates = gates / gates.sum(-1, keepdim=True).clamp(min=1e-9)
    gates = gates * _keep(idx, row, d)
    hq = p.act(h)
    out = torch.zeros_like(h)
    for e in range(d.E):
        tok, choice = torch.nonzero(idx == e, as_tuple=True)
        if tok.numel() == 0:
            continue
        x = hq[tok]
        act = F.silu(x @ p.weight(W["gate"][l, e])) * (x @ p.weight(W["up"][l, e]))
        y = p.act(act) @ p.weight(W["down"][l, e])
        out.index_add_(0, tok, y * gates[tok, choice, None])
    return out


@torch.no_grad()
def served_logits(W: Dict[str, torch.Tensor], cfg: Dict,
                  seqs: List[Tuple[torch.Tensor, int]], fp8: bool = False,
                  block: int = 512, kv_of: Optional[int] = None):
    """For each served sequence (``tokens`` (T,): the prompt and then the
    served tokens but the last; ``prompt`` its length P), the logits
    (T - P + 1, V) float32 at positions P-1 .. T-1, which chose the served
    tokens. ``fp8``: the matrix products in float8 (``_Precision``).
    ``kv_of``: also return, for that sequence, each layer's (k, v), each
    (T, KV, Dh) float32, k after RoPE: what a decode cache holds."""
    d = dims(cfg)
    p = _Precision(fp8)
    dev = W["embed"].device
    xs = [W["embed"][t.to(dev)].float() for t, _ in seqs]
    T_max = max(x.shape[0] for x in xs)
    inv = d.theta ** (-torch.arange(0, d.Dh, 2, dtype=torch.float64,
                                    device=dev) / d.Dh)
    ang = torch.arange(T_max, dtype=torch.float64, device=dev)[:, None] * inv
    cos, sin = ang.cos().float()[:, None], ang.sin().float()[:, None]
    # the batch row of every token: the prompt one row, each later token
    # one row of its own
    rows, base = [], 0
    for x, (_, P) in zip(xs, seqs):
        T = x.shape[0]
        r = torch.zeros(T, dtype=torch.long, device=dev)
        r[P:] = torch.arange(1, T - P + 1, device=dev)
        rows.append(r + base)
        base += T - P + 1
    row = torch.cat(rows)
    kv = []
    for l in range(d.L):
        wq, wk, wv = (p.weight(W[n][l]).reshape(d.D, -1) for n in ("wq", "wk", "wv"))
        wo = p.weight(W["wo"][l]).reshape(d.H * d.Dh, d.D)
        for i, x in enumerate(xs):
            T = x.shape[0]
            h = p.act(_rmsnorm(x, W["attn_norm"][l], d.eps))
            q = _rope((h @ wq).view(T, d.H, d.Dh), cos[:T], sin[:T])
            k = _rope((h @ wk).view(T, d.KV, d.Dh), cos[:T], sin[:T])
            v = (h @ wv).view(T, d.KV, d.Dh)
            if i == kv_of:
                kv.append((k, v))
            x += p.act(_attention(q, k, v, d, block)) @ wo
        h = torch.cat([_rmsnorm(x, W["mlp_norm"][l], d.eps) for x in xs])
        out = _moe(h, row, W, l, d, p).split([x.shape[0] for x in xs])
        for x, o in zip(xs, out):
            x += o
    head = p.weight(W["lm_head"])
    logits = [p.act(_rmsnorm(x[P - 1:], W["final_norm"], d.eps)) @ head.T
              for x, (_, P) in zip(xs, seqs)]
    return logits if kv_of is None else (logits, kv)


def logit_gaps(ref: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """How far each token's reference logit lies below the reference's best
    at its position, in units of that position's logit standard deviation:
    ref (n, V), tokens (n,) -> (n,)."""
    tokens = tokens.to(ref.device).long()
    chosen = ref.gather(1, tokens[:, None])[:, 0]
    return (ref.amax(1) - chosen) / ref.std(1)
