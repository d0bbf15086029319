"""A plain-torch mirror of the ``gla_scan`` kernels' arithmetic, for the CPU
tests (``tests/test_torch_gla_design.py``: the bf16 route;
``tests/test_torch_gla_f32_design.py``: the float32 route). Both routes of
``src/repro_torch/kernels/gla_scan/csrc/gla_scan.cu`` share one
decomposition, which ``design_scan`` follows step by step in log2 units:

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

Per-token log2 decays are clamped at -64 first, as in the kernels. Every
exponent the mirror forms is recorded. The matrix products are taken as
the kernels' tensor cores take them: in plain float32, or with every
operand split into a bf16 pair (``bf16=True``; the output then rounded to
bf16) or a TF32 pair (``tf32=True``; ``cvt.rna``: round to nearest, ties
away from zero, 10 explicit mantissa bits), three products with lo @ lo
dropped; ``split=False`` takes one rounding of each operand instead of the
pair. Nothing on the port's main path calls this module.
"""
import jax.numpy as jnp
import numpy as np
import torch

from repro.kernels.gla_scan import gla_scan as jax_gla_scan
from repro_torch.models.linear_attention import gla_reference

LOG2E = 1.4426950408889634
C = 64      # tokens per chunk of the kernels
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


def tf32_rna(x):
    """``cvt.rna.tf32.f32`` on the float32 bits: round to nearest with
    ties away from zero, keeping 10 explicit mantissa bits (the low 13 bits
    0). Adding half an ulp of the kept bits to the sign-magnitude pattern
    rounds the magnitude, whatever the sign."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def design_scan(q, k, v, log_w, u=None, mode="ssd", bf16=False, split=True,
                tf32=False):
    """The kernels' decomposition in plain torch. Model layout (B, T, H, .).
    Returns (o (B, T, H, V) float32, final state (B, H, K, V) float32, the
    largest exponent formed). ``bf16``: round as the bf16 route does;
    ``tf32``: as the float32 route does; with ``split=False`` each operand
    as one value instead of a pair."""
    rnd = (lambda x: x.to(torch.bfloat16).float()) if bf16 else \
        tf32_rna if tf32 else (lambda x: x)
    top = [-float("inf")]

    def mm(a, b):
        """a @ b as the kernels' tensor cores take it: each float32 operand
        split into a bf16 or TF32 pair hi + lo, three products (lo @ lo
        dropped)."""
        if not (bf16 or tf32):
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
    return (rnd(o) if bf16 else o), s, top[0]


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


def hold_to_reference_and_pallas(seed, B, T, H, K, V, mode, decay, **rounding):
    """The mirror (``rounding``: ``design_scan``'s keywords) on ``_inputs``
    against the exact scan at ``TOL[decay]``, every exponent <= 0, and
    against the JAX package's Pallas kernel in interpret mode (16-token
    chunks), except where the Pallas kernel itself leaves the tolerance
    (``mixed``, and ``clamp`` in rwkv mode, past one token: it forms rwkv's
    read decay from chunk-wide sums), which is asserted instead."""
    q, k, v, lw, u = _inputs(seed, B, T, H, K, V, mode, decay)
    o, s, top = design_scan(q, k, v, lw, u=u, mode=mode, **rounding)
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
        # exact scan here (the docstring says why), where the
        # mirror's stays inside it (asserted above): hold that, not the
        # mirror against the Pallas kernel
        assert np.isfinite(jo).all() and np.isfinite(js).all()
        excess = np.abs(jo - ro.numpy()) - TOL[decay] * (1 + np.abs(ro.numpy()))
        assert excess.max() > 0, "the Pallas kernel now holds the tolerance"
        return
    np.testing.assert_allclose(o.numpy(), jo, **tol)
    np.testing.assert_allclose(s.numpy(), js, **tol)
