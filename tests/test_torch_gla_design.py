"""The arithmetic of the bf16 ``gla_scan`` kernel's design, on the CPU.

The bf16 path of ``src/repro_torch/kernels/gla_scan/csrc/gla_scan.cu`` runs
only on the card. This file holds a plain-torch mirror of its decomposition
and checks it against the token-by-token scan (``gla_reference``) and the
JAX package's Pallas kernel in interpret mode, as ``tests/test_kernels.py``
runs it. The mirror follows the kernel step by step, in log2 units:

* chunks of ``C`` = 64 tokens, sub-chunks of 16;
* chunk-local states ``dS_c = (k * 2^(sum of later log w in the chunk))^T v``
  and chunk decays ``2^(sum of log w over the chunk)``;
* the prefix over chunks ``S_c = decay_c * S_(c-1) + dS_c``;
* per sub-chunk ``a``: the inter term ``(q * 2^(P_a + Lr)) @ S_(c-1)``; the
  off-diagonal sub-blocks ``b < a`` factored at the start of ``a``,
  ``A_ab = (q * 2^(Lr + G_ab)) @ (k * 2^(Sloc))^T``, with local cumulative
  decays that never subtract one chunk-wide sum from another; the diagonal
  sub-block pairwise, ``2^(Lr_t - Ll_j)`` on the pairs the causal mask keeps,
  with the rwkv bonus ``u`` on its diagonal.

Per-token log2 decays are clamped at -64 first, as in the kernel: a pair
or a state across such a token keeps a weight below 2^-64 either way, and
the clamp bounds the local cumulative decays of a sub-chunk by 16 * 64, so
their differences in the diagonal sub-block keep ~1e-4 relative accuracy
even where RWKV6's floor of -22026 per token sits beside weak decays.
Every exponent the mirror forms is recorded and must be <= 0, whatever the
decay. With ``bf16=True`` the mirror takes its products as the kernel's
tensor cores do, each float32 operand split into a bf16 pair (hi + lo, three
products), and rounds the output to bf16, so the bf16 case shows that those
roundings hold the bf16 tolerance (one bf16 rounding of an operand, in
place of the pair, did not at T = 2048 with weak decays).

Tolerances: float32 2e-4 (``tests/test_kernels.py``); extreme decay 1e-3
(cumulative log decays reach ~1e3 inside a chunk, where a float32 ulp is
~6e-5, so exp of a difference of two of them carries ~1e-4 relative error
in any chunked form); bfloat16 5e-2. The Pallas kernel runs with 16-token
chunks: at 32 its own chunk-wide cumulative decays put it outside the
extreme tolerance against the exact scan. Under RWKV6's floor the Pallas
kernel forms rwkv's read decay as ``L - log w`` from sums of ~1e6, off by
their float32 rounding, and any chunked form that subtracts unclamped
cumulative sums loses digits where the floor sits beside weak decays; the
``clamp`` (rwkv) and ``mixed`` decays past one token therefore hold the
mirror against the exact scan, and assert that the Pallas kernel's output
leaves the tolerance there.

The float32 kernel (``gla_scan_kernel``: 32-token chunks, each two
sub-chunks of 16 whose cumulative sums start afresh, natural-log decays
clamped at -64 ln 2) has its own mirror, ``f32_kernel_scan``. Both it and
the plain chunked scan ``gla_chunked`` are held against the exact scan at
every decay; neither subtracts chunk-wide cumulative sums any more.

The mirrors live here only: nothing on the port's main path calls them.
"""
import math
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.gla_scan import gla_scan as jax_gla_scan
from repro_torch.kernels.gla_scan import ops as gla_ops
from repro_torch.models.linear_attention import gla_chunked, gla_reference

LOG2E = 1.4426950408889634
C = 64      # tokens per chunk of the bf16 kernel
SUB = 16    # tokens per sub-chunk (one warp's rows, one mma tile)
NSUB = C // SUB
LW2_FLOOR = 64.0   # per-token log2 decays are clamped at -64


def _prefix(x, dim):
    """Inclusive prefix sums along ``dim``, added in order as the kernel does."""
    out, acc = torch.empty_like(x), torch.zeros_like(x.select(dim, 0))
    for i in range(x.shape[dim]):
        acc = acc + x.select(dim, i)
        out.select(dim, i).copy_(acc)
    return out


def _suffix(x, dim):
    """Exclusive suffix sums along ``dim``, added from the end."""
    out, acc = torch.empty_like(x), torch.zeros_like(x.select(dim, 0))
    for i in reversed(range(x.shape[dim])):
        out.select(dim, i).copy_(acc)
        acc = acc + x.select(dim, i)
    return out


def design_scan(q, k, v, log_w, u=None, mode="ssd", bf16=False, split=True):
    """The kernel's decomposition in plain torch. Model layout (B, T, H, .).
    Returns (o (B, T, H, V) float32, final state (B, H, K, V) float32, the
    largest exponent formed). ``bf16``: round as the kernel does; with
    ``split=False`` each operand as one bf16 value instead of a pair."""
    rnd = (lambda x: x.to(torch.bfloat16).float()) if bf16 else (lambda x: x)
    top = [-float("inf")]

    def mm(a, b):
        """a @ b as the kernel's tensor cores take it: each float32 operand
        split into a bf16 pair hi + lo, three products (lo @ lo dropped)."""
        if not bf16:
            return a @ b
        a_hi, b_hi = rnd(a), rnd(b)
        if not split:
            return a_hi @ b_hi
        a_lo, b_lo = rnd(a - a_hi), rnd(b - b_hi)
        return a_hi @ b_hi + (a_hi @ b_lo + a_lo @ b_hi)

    def exp2(x):
        if x.numel():
            top[0] = max(top[0], float(x.max()))
        return torch.exp2(x)

    B, T, H, K = q.shape
    V = v.shape[-1]
    nc = -(-T // C)
    pad = nc * C - T

    def chunks(x):  # (B, T, H, .) -> (B, H, nc, C, .); past T: 0 (log w = 0)
        x = torch.nn.functional.pad(x.float(), (0, 0, 0, 0, 0, pad))
        return x.reshape(B, nc, C, H, -1).permute(0, 3, 1, 2, 4)

    qc, kc, vc, lc = map(chunks, (q, k, v, log_w))
    l2 = torch.clamp(lc * LOG2E, min=-LW2_FLOOR)

    # per (sub-chunk, channel): local inclusive log2 decay, its total, and
    # the exclusive suffix inside the sub-chunk
    subchunks = lambda x: x.reshape(B, H, nc, NSUB, SUB, x.shape[-1])
    qs, ks, vs, ls = map(subchunks, (qc, kc, vc, l2))
    ll = _prefix(ls, 4)
    sub_total = ll[..., SUB - 1, :]           # (B, H, nc, NSUB, K)
    sloc = _suffix(ls, 4)

    # chunk-local states and chunk decays (one CTA per (chunk, head, batch)):
    # the decay after token j is its sub-chunk's suffix plus the totals of
    # the later sub-chunks
    later = torch.zeros_like(sub_total)
    for s_ in range(NSUB):
        for s2 in range(s_ + 1, NSUB):
            later[..., s_, :] = later[..., s_, :] + sub_total[..., s2, :]
    k_dec = (ks * exp2(sloc + later[..., None, :])).reshape(B, H, nc, C, K)
    d_s = mm(k_dec.transpose(3, 4), vc)                       # (B, H, nc, K, V)
    total = torch.zeros_like(sub_total[..., 0, :])
    for s_ in range(NSUB):
        total = total + sub_total[..., s_, :]
    decay = exp2(total)                                       # (B, H, nc, K)

    # prefix over chunks: the state entering each chunk, and the final one
    s_in = torch.empty_like(d_s)
    s = torch.zeros_like(d_s[:, :, 0])
    for c in range(nc):
        s_in[:, :, c] = s
        s = decay[:, :, c, :, None] * s + d_s[:, :, c]

    # outputs: one warp per sub-chunk a of each chunk
    if mode == "rwkv":                        # read before the token's decay
        lr = torch.cat([torch.zeros_like(ll[..., :1, :]), ll[..., :-1, :]], 4)
    else:
        lr = ll
    q_t = qs * exp2(lr)                       # float32, in registers
    k_suf = ks * exp2(sloc)
    t_idx = torch.arange(SUB)
    keep = (t_idx[:, None] > t_idx[None, :]) if mode == "rwkv" \
        else (t_idx[:, None] >= t_idx[None, :])
    outs = []
    for a in range(NSUB):
        p_a = torch.zeros_like(sub_total[..., 0, :])
        for s_ in range(a):
            p_a = p_a + sub_total[..., s_, :]
        qa = q_t[..., a, :, :]
        o_a = mm(qa * exp2(p_a)[..., None, :], s_in)                 # inter
        g = torch.zeros_like(p_a)             # off-diagonal, nearest first:
        for b in reversed(range(a)):          # g = decay strictly between
            att = mm(qa * exp2(g)[..., None, :],
                     k_suf[..., b, :, :].transpose(-1, -2))
            o_a = o_a + mm(att, vs[..., b, :, :])
            g = g + sub_total[..., b, :]
        # diagonal sub-block: pairwise, exp only where the mask keeps the pair
        diff = lr[..., a, :, None, :] - ll[..., a, None, :, :]      # (.., t, j, K)
        diff = torch.where(keep[:, :, None], diff, -float("inf"))
        w = exp2(diff)
        if mode == "rwkv":                    # the bonus on the diagonal
            eye = torch.eye(SUB, dtype=torch.bool)[:, :, None]
            w = torch.where(eye, u.float()[None, :, None, None, None, :], w)
        att = torch.einsum("...tk,...jk,...tjk->...tj", qs[..., a, :, :],
                           ks[..., a, :, :], w)
        o_a = o_a + mm(att, vs[..., a, :, :])
        outs.append(o_a)
    o = torch.stack(outs, 3).reshape(B, H, nc * C, V)[:, :, :T].transpose(1, 2)
    return rnd(o), s, top[0]


F32_CHUNK, F32_SUB = 32, 16       # the float32 kernel's chunk and sub-chunk
LW_FLOOR = -64.0 * math.log(2.0)  # its per-token clamp, in natural log


def f32_kernel_scan(q, k, v, log_w, u=None, mode="ssd"):
    """The float32 kernel's arithmetic in plain torch, model layout. Per
    chunk: local inclusive sums ``ll``, read sums ``lr`` (the sum before the
    token's own decay for rwkv), exclusive suffixes ``suf`` and totals
    ``tot`` of each sub-chunk; pairs inside a sub-chunk take ``lr - ll``,
    pairs from the first to the second ``lr + suf``."""
    B, T, H, K = q.shape
    V = v.shape[-1]
    nc = -(-T // F32_CHUNK)
    pad = nc * F32_CHUNK - T

    def chunks(x):  # (B, T, H, .) -> (B, H, nc, C, .); past T: 0
        x = torch.nn.functional.pad(x.float(), (0, 0, 0, 0, 0, pad))
        return x.reshape(B, nc, F32_CHUNK, H, -1).permute(0, 3, 1, 2, 4)

    qc, kc, vc, lc = map(chunks, (q, k, v, log_w))
    lc = torch.clamp(lc, min=LW_FLOOR)
    sub = torch.arange(F32_CHUNK) // F32_SUB
    t_idx = torch.arange(F32_CHUNK)
    keep = (t_idx[:, None] > t_idx[None, :]) if mode == "rwkv" \
        else (t_idx[:, None] >= t_idx[None, :])
    cross = (sub[:, None] == 1) & (sub[None, :] == 0)
    s, outs = torch.zeros(B, H, K, V), []
    for c in range(nc):
        qb, kb, vb = qc[:, :, c], kc[:, :, c], vc[:, :, c]
        ls = lc[:, :, c].reshape(B, H, 2, F32_SUB, K)
        ll = torch.cumsum(ls, 3)
        lr = torch.nn.functional.pad(ll[..., :-1, :], (0, 0, 1, 0)) \
            if mode == "rwkv" else ll
        tot = ll[..., -1, :]                                   # (B, H, 2, K)
        suf = torch.flip(torch.cumsum(torch.flip(ls, [3]), 3), [3])
        suf = torch.nn.functional.pad(suf[..., 1:, :], (0, 0, 0, 1))
        ll, lr, suf = (x.reshape(B, H, F32_CHUNK, K) for x in (ll, lr, suf))
        e = torch.where(cross[:, :, None], lr[:, :, :, None] + suf[:, :, None],
                        lr[:, :, :, None] - ll[:, :, None])
        e = torch.where(keep[:, :, None], e, -float("inf"))
        att = torch.einsum("bhtk,bhjk,bhtjk->bhtj", qb, kb, torch.exp(e))
        o = att @ vb
        if mode == "rwkv":
            o = o + torch.einsum("bhtk,hk,bhtk->bht", qb, u, kb)[..., None] * vb
        lread = lr + torch.where(sub[:, None] == 1, tot[:, :, :1], 0.0)
        o = o + (qb * torch.exp(lread)) @ s
        k_dec = kb * torch.exp(suf + torch.where(sub[:, None] == 0, tot[:, :, 1:], 0.0))
        s = torch.exp(tot.sum(2))[..., None] * s + k_dec.transpose(2, 3) @ vb
        outs.append(o)
    o = torch.stack(outs, 2).reshape(B, H, nc * F32_CHUNK, V)[:, :, :T]
    return o.transpose(1, 2), s


def _inputs(seed, B, T, H, K, V, mode, decay, dtype=torch.float32):
    """numpy draws: normal q/k/v rounded to ``dtype``, float32 log w, a
    bonus u for rwkv."""
    rng = np.random.default_rng(seed)
    q, k = (rng.standard_normal((B, T, H, K), dtype=np.float32) for _ in range(2))
    v = rng.standard_normal((B, T, H, V), dtype=np.float32)
    shape = (B, T, H, K)
    if decay == "sweep":      # tests/test_kernels.py: |log w| up to 12
        lw = -np.exp(rng.uniform(-6.0, 2.5, shape))
    elif decay == "extreme":  # tests/test_torch_card.py: |log w| up to 40
        lw = -rng.uniform(0.0, 40.0, shape)
    elif decay == "clamp":    # RWKV6's floor: -exp(10) = -22026 per token
        lw = np.full(shape, -np.exp(10.0))
    else:                     # each token and channel at the floor or weak
        lw = np.where(rng.uniform(size=shape) < 0.5, -np.exp(10.0),
                      -np.exp(rng.uniform(-6.0, 0.0, shape)))
    u = 0.3 * rng.standard_normal((H, K), dtype=np.float32) if mode == "rwkv" else None
    t = lambda x: None if x is None else torch.from_numpy(np.asarray(x, np.float32))
    q, k, v = (t(x).to(dtype).float() for x in (q, k, v))
    return q, k, v, t(lw), t(u)


TOL = {"sweep": 2e-4, "extreme": 1e-3, "clamp": 1e-3, "mixed": 1e-3}
SHAPES = [(1, 1, 2, 16, 16), (2, 130, 2, 64, 64), (1, 200, 2, 32, 48),
          (1, 64, 1, 16, 64)]


@pytest.mark.parametrize("B,T,H,K,V", SHAPES)
@pytest.mark.parametrize("mode", ["ssd", "rwkv"])
@pytest.mark.parametrize("decay", list(TOL))
def test_design_matches_reference_and_pallas(B, T, H, K, V, mode, decay):
    q, k, v, lw, u = _inputs(5, B, T, H, K, V, mode, decay)
    o, s, top = design_scan(q, k, v, lw, u=u, mode=mode)
    assert top <= 0.0, f"an exponent of {top} was formed"
    assert torch.isfinite(o).all() and torch.isfinite(s).all()
    tol = dict(rtol=TOL[decay], atol=TOL[decay])
    ro, rs = gla_reference(q, k, v, lw, u=u, mode=mode)
    np.testing.assert_allclose(o.numpy(), ro.numpy(), **tol)
    np.testing.assert_allclose(s.numpy(), rs.numpy(), **tol)
    j = lambda x: None if x is None else jnp.asarray(x.numpy())
    jo, js = jax_gla_scan(j(q), j(k), j(v), j(lw), u=j(u), mode=mode,
                          chunk=16, interpret=True)
    jo, js = np.asarray(jo, np.float32), np.asarray(js, np.float32)
    if T > 1 and (decay == "mixed" or (decay == "clamp" and mode == "rwkv")):
        # the Pallas kernel's own output leaves the tolerance against the
        # exact scan here (the module docstring says why), where the
        # mirror's stays inside it (asserted above): hold that, not the
        # mirror against the Pallas kernel
        assert np.isfinite(jo).all() and np.isfinite(js).all()
        excess = np.abs(jo - ro.numpy()) - TOL[decay] * (1 + np.abs(ro.numpy()))
        assert excess.max() > 0, "the Pallas kernel now holds the tolerance"
        return
    np.testing.assert_allclose(o.numpy(), jo, **tol)
    np.testing.assert_allclose(s.numpy(), js, **tol)


@pytest.mark.parametrize("mode", ["ssd", "rwkv"])
@pytest.mark.parametrize("decay", ["sweep", "extreme", "mixed"])
@pytest.mark.parametrize("T", [65, 2048])
def test_design_bf16_roundings_hold_the_bf16_tolerance(mode, decay, T):
    """bf16 q/k/v, float32 log w (the model's inputs), and the mirror rounded
    to bf16 where the kernel feeds its tensor cores: 5e-2 against the exact
    scan of the same inputs, outputs finite."""
    q, k, v, lw, u = _inputs(7, 1, T, 2, 64, 64, mode, decay, torch.bfloat16)
    o, s, top = design_scan(q, k, v, lw, u=u, mode=mode, bf16=True)
    assert top <= 0.0
    assert torch.isfinite(o).all() and torch.isfinite(s).all()
    ro, rs = gla_reference(q, k, v, lw, u=u, mode=mode)
    np.testing.assert_allclose(o.numpy(), ro.numpy(), rtol=5e-2, atol=5e-2)
    np.testing.assert_allclose(s.numpy(), rs.numpy(), rtol=5e-2, atol=5e-2)


def test_design_chunk_is_the_wrappers():
    """The mirror's chunk and sub-chunk tiles are the bf16 kernels' own, as
    their source states them (the wrapper takes the chunk and the scratch
    size from the built library; ``tests/test_torch_card.py`` holds those
    against this mirror on the card)."""
    src = (Path(gla_ops.__file__).parent / "csrc" / "gla_scan.cu").read_text()
    tile = lambda name: int(re.search(rf"constexpr int {name} = (\d+);", src)[1])
    assert (tile("MC"), tile("SUB")) == (C, SUB)
    assert -LW2_FLOOR == float(re.search(r"LW2_FLOOR = (-[\d.]+)f;", src)[1])


@pytest.mark.parametrize("mode", ["ssd", "rwkv"])
def test_design_single_bf16_roundings_miss_the_bf16_tolerance(mode):
    """Why the kernel takes each float32 operand as a bf16 pair: the same
    products with one bf16 rounding per operand leave the 5e-2 tolerance at
    the served length, where weak decays let the state grow."""
    q, k, v, lw, u = _inputs(7, 1, 2048, 2, 64, 64, mode, "sweep", torch.bfloat16)
    ro, _ = gla_reference(q, k, v, lw, u=u, mode=mode)
    excess = {}
    for split in (True, False):
        o, _, _ = design_scan(q, k, v, lw, u=u, mode=mode, bf16=True, split=split)
        excess[split] = float(((o - ro).abs() - 5e-2 * ro.abs()).max())
    assert excess[True] <= 5e-2 < excess[False]


@pytest.mark.parametrize("B,T,H,K,V", SHAPES)
@pytest.mark.parametrize("mode", ["ssd", "rwkv"])
@pytest.mark.parametrize("decay", list(TOL))
def test_chunked_scans_match_the_exact_scan(B, T, H, K, V, mode, decay):
    """``gla_chunked`` (RWKV6's einsum prefill) and the float32 kernel's
    mirror hold the exact scan at every decay, RWKV6's floor included,
    outputs and final state. The reference's ``gla_chunked`` misses it at
    ``clamp`` (rwkv: max |do| 3.55 at T = 130) and ``mixed``; the port's
    agrees with the reference's at ``sweep`` decays
    (``tests/test_torch_rwkv.py``)."""
    q, k, v, lw, u = _inputs(5, B, T, H, K, V, mode, decay)
    tol = dict(rtol=TOL[decay], atol=TOL[decay])
    ro, rs = gla_reference(q, k, v, lw, u=u, mode=mode)
    for o, s in (gla_chunked(q, k, v, lw, u=u, mode=mode),
                 f32_kernel_scan(q, k, v, lw, u=u, mode=mode)):
        assert torch.isfinite(o).all() and torch.isfinite(s).all()
        np.testing.assert_allclose(o.numpy(), ro.numpy(), **tol)
        np.testing.assert_allclose(s.numpy(), rs.numpy(), **tol)


def test_f32_mirror_tiles_are_the_kernels():
    """The float32 mirror's chunk, sub-chunk and clamp are the kernel's."""
    src = (Path(gla_ops.__file__).parent / "csrc" / "gla_scan.cu").read_text()
    tile = lambda name: int(re.search(rf"constexpr int {name} = (\d+);", src)[1])
    assert (tile("CHUNK"), tile("SUB32")) == (F32_CHUNK, F32_SUB)
    floor = float(re.search(r"LW_FLOOR = (-[\d.]+)f;", src)[1])
    assert floor == pytest.approx(LW_FLOOR, rel=1e-12)
