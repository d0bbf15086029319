"""Whether the window's served tokens, and the cache they were served from,
are right.

The tokens: a sample of the requests finished in the window, drawn from the
seed with the longest among them, run once through the plain float32
reference over each prompt and its served tokens. Each served token's gap
is how far its reference logit lies below the reference's best at its
position, in units of that position's logit standard deviation. The number
compared is the mean gap over the sample's served tokens
(``logit_gap_mean_sd``); the widest gap is printed beside it. The widest gap
cannot separate a sound bf16 program from the float8 control: near-ties in
the MoE router flip experts in both, and a flipped expert moves a token's
logits about as far in either (``PERF.md``).

The cache: the K/V rows of one request as they stood in the engine's cache
at the window's close (``run.kv_snapshot``), against the k (after RoPE) and
v that the same reference pass computes for that request: each layer's
relative error ||cache - reference|| / ||reference|| of K and of V, over
the rows the prefill wrote and over those the decode steps wrote. With
weights drawn at random, attention spreads over the whole context, and a
decode step that loses its own K/V write moves the served tokens little:
these rows see it. The number compared (``kv_rel_err_layer0``, where the
cell's limits name it) is the first layer's worst of the four; every
layer's is printed beside it. A deeper layer's rows carry the drift of the
bf16 residual stream from the float32 one, which grows through the layers
in the program and in the float8 control alike (``PERF.md``), so the worst
layer cannot separate the two; the first layer's rows hold only the
embedding, the norm, the projections, RoPE and the cache write.
"""
from __future__ import annotations

import numpy as np
import torch


def sample(done, rng, served_tokens: int, sequence_tokens: int):
    """The longest request (most served tokens, then longest prompt), then
    others in an order drawn from ``rng``, until ``served_tokens`` served
    tokens are in the sample or one more would pass ``sequence_tokens``
    tokens of prompts and served tokens together."""
    if not done:
        raise RuntimeError("no request finished in the window: nothing to check")
    longest = max(range(len(done)),
                  key=lambda i: (len(done[i].tokens), len(done[i].prompt)))
    picked = [done[longest]]
    size = lambda s: len(s.prompt) + len(s.tokens)
    for i in rng.permutation(len(done)):
        if sum(len(s.tokens) for s in picked) >= served_tokens:
            break
        if i != longest and sum(map(size, picked)) + size(done[i]) <= sequence_tokens:
            picked.append(done[i])
    return picked


def _seq(prompt, tokens):
    """(the prompt and every served token but the last, P): what the
    reference runs over for a request."""
    return (torch.as_tensor(np.concatenate([np.asarray(prompt), np.asarray(
        tokens[:-1], np.int64)]).astype(np.int64)), len(prompt))


def reference_pass(ref, W, cfg, picked, snap=None, fp8: bool = False):
    """One pass of the reference (float32, or the ``fp8`` control) over the
    picked requests and, with ``snap``, the snapshot's request after them:
    (each picked request's logits, the snapshot's per-layer (k, v) or
    None)."""
    seqs = [_seq(s.prompt, s.tokens) for s in picked]
    if snap is None:
        return ref.served_logits(W, cfg, seqs, fp8=fp8), None
    seqs.append(_seq(snap.prompt, snap.tokens))
    logits, kv = ref.served_logits(W, cfg, seqs, fp8=fp8, kv_of=len(picked))
    return logits[:-1], kv


def served_gaps(ref, logits, picked):
    """Each picked request's gaps of its served tokens below ``logits``'
    best, as numpy arrays."""
    return [ref.logit_gaps(l, torch.as_tensor(s.tokens)).cpu().numpy()
            for l, s in zip(logits, picked)]


def control_gaps(ref, logits, low):
    """The control's gaps: at each position, the gap below ``logits``' best
    of the token that the low-precision logits ``low`` put first."""
    return [ref.logit_gaps(l, q.argmax(1)).cpu().numpy()
            for l, q in zip(logits, low)]


def kv_errors(k, v, ref_kv, prompt: int) -> np.ndarray:
    """(L, 2, 2) relative errors ||x - reference|| / ||reference|| of K and
    V (axis 1) over the prompt's rows and over the decode steps' rows (axis
    2; nan where a group has no row): ``k``/``v`` each layer's (n, KV, Dh)
    rows from position 0, as a tensor (L, n, KV, Dh) or a list; ``ref_kv``
    each layer's reference (k, v), (n, KV, Dh)."""
    n = k[0].shape[0]
    groups = [(0, min(prompt, n)), (prompt, n)]
    out = np.full((len(ref_kv), 2, 2), np.nan)
    for l, pair in enumerate(ref_kv):
        for j, (got, want) in enumerate(zip((k[l], v[l]), pair)):
            for g, (a, b) in enumerate(groups):
                if b > a:
                    w = want[a:b].float()
                    e = got[a:b].to(w.device).float() - w
                    out[l, j, g] = float(e.norm() / w.norm().clamp(min=1e-30))
    return out


def describe_kv(kv: np.ndarray) -> str:
    """Each group's relative errors by layer, the worst of K and V."""
    return "; ".join(
        f"{name} rows, relative error by layer (worst of K and V): "
        f"{np.round(kv[:, :, g].max(1), 5).tolist()}"
        for g, name in enumerate(("prompt", "decode"))
        if not np.isnan(kv[:, :, g]).all())


def numbers(gaps: np.ndarray, kv: np.ndarray = None) -> dict:
    """The numbers compared: from the served tokens' gaps, and from the
    cache's relative errors where they were read."""
    out = {"logit_gap_mean_sd": float(gaps.mean())}
    if kv is not None:
        out["kv_rel_err_layer0"] = float(np.nanmax(kv[0]))
    return out


def check(ref, W, cfg, done, limits, rng, snap=None):
    """The numbers compared, each beside its limit. ``snap``: the cache rows
    of one request (``run.kv_snapshot``), read where the limits name
    ``kv_rel_err_layer0``."""
    picked = sample(done, rng, limits["served_tokens"], limits["sequence_tokens"])
    kv_wanted = "kv_rel_err_layer0" in limits
    if kv_wanted and snap is None:
        raise RuntimeError("the cell's check reads the cache, and no cache "
                           "rows were taken")
    logits, ref_kv = reference_pass(ref, W, cfg, picked,
                                    snap if kv_wanted else None)
    gaps = np.concatenate(served_gaps(ref, logits, picked))
    kv = kv_errors(snap.k, snap.v, ref_kv, len(snap.prompt)) if kv_wanted else None
    print(f"check: {len(picked)} requests, {gaps.size} served tokens, "
          f"{sum(len(s.prompt) for s in picked)} prompt tokens; gaps in logit "
          f"sd: mean {gaps.mean()!r}, widest {gaps.max()!r}, "
          f"{int((gaps > 0).sum())} tokens not the reference's first")
    if kv is not None:
        print(f"check: cache rows of a request of {len(snap.prompt)} prompt "
              f"and {len(snap.tokens)} served tokens; " + describe_kv(kv))
    out = {name: {"value": value, "limit": limits[name]}
           for name, value in numbers(gaps, kv).items()}
    out["wrong_token_counts"] = {
        "value": sum(len(s.tokens) != s.new_tokens for s in picked), "limit": 0}
    return out
