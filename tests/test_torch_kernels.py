"""The port's attention kernels against the JAX reference, on the CPU.

On CPU tensors each wrapper runs its kernel's plain PyTorch version; these
tests hold it against ``repro``'s Pallas kernel (interpret mode) and its
``ref.py`` oracle on the ``tests/test_kernels.py`` sweeps, with the same
numpy inputs. The CUDA kernels themselves run only on the card:
``tests/test_torch_card.py`` holds them against the plain versions there.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.decode_attention import decode_attention as jax_decode
from repro.kernels.decode_attention import (
    decode_attention_reference as jax_decode_ref)
from repro.kernels.flash_attention import attention_reference as jax_flash_ref
from repro.kernels.flash_attention import flash_attention as jax_flash
from repro_torch.kernels.decode_attention import (decode_attention,
                                                  decode_attention_reference)
from repro_torch.kernels.flash_attention import (attention_reference,
                                                 flash_attention)

DTYPES = {"float32": (torch.float32, jnp.float32),
          "bfloat16": (torch.bfloat16, jnp.bfloat16)}
FLASH_SHAPES = [(1, 128, 4, 4, 64), (2, 256, 4, 2, 64),
                (1, 200, 8, 1, 32),   # unpadded seq, MQA
                (2, 64, 6, 3, 80)]    # odd heads / head_dim
FLASH_MASKS = [(True, None), (True, 64), (False, None)]
DECODE_SHAPES = [(2, 512, 8, 2, 64), (1, 1024, 4, 4, 128), (3, 300, 6, 3, 80)]


def _tol(dtype):
    return dict(rtol=2e-2, atol=2e-2) if dtype == "bfloat16" \
        else dict(rtol=2e-5, atol=2e-5)


def _inputs(rng, dtype, *shapes):
    """Normal draws rounded to ``dtype``: (torch tensors, jax arrays)."""
    tdt, jdt = DTYPES[dtype]
    ts = [torch.from_numpy(rng.standard_normal(s, dtype=np.float32)).to(tdt)
          for s in shapes]
    js = [jnp.asarray(t.float().numpy(), jdt) for t in ts]
    return ts, js


def _np(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else x,
                      np.float32)


@pytest.mark.parametrize("B,S,H,KV,D", FLASH_SHAPES)
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("causal,window", FLASH_MASKS)
def test_flash_attention_matches_reference(B, S, H, KV, D, dtype, causal,
                                           window):
    (q, k, v), (jq, jk, jv) = _inputs(np.random.default_rng(0), dtype,
                                      (B, S, H, D), (B, S, KV, D), (B, S, KV, D))
    out = flash_attention(q, k, v, causal=causal, window=window)
    assert out.shape == q.shape and out.dtype == q.dtype
    pallas = jax_flash(jq, jk, jv, causal=causal, window=window, interpret=True)
    tr = lambda x: x.transpose(0, 2, 1, 3)
    oracle = tr(jax_flash_ref(tr(jq), tr(jk), tr(jv), causal=causal,
                              window=window))
    np.testing.assert_allclose(_np(out), _np(pallas), **_tol(dtype))
    np.testing.assert_allclose(_np(out), _np(oracle), **_tol(dtype))


@pytest.mark.parametrize("B,W,H,KV,D", DECODE_SHAPES)
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_decode_attention_matches_reference(B, W, H, KV, D, dtype):
    rng = np.random.default_rng(1)
    (q, kc, vc), (jq, jkc, jvc) = _inputs(rng, dtype, (B, 1, H, D),
                                          (B, W, KV, D), (B, W, KV, D))
    lengths = rng.integers(1, W + 1, B).astype(np.int32)
    out = decode_attention(q, kc, vc, torch.from_numpy(lengths))
    assert out.shape == q.shape and out.dtype == q.dtype
    pallas = jax_decode(jq, jkc, jvc, jnp.asarray(lengths), interpret=True)
    oracle = jax_decode_ref(jq.reshape(B, KV, H // KV, D),
                            jkc.transpose(0, 2, 1, 3), jvc.transpose(0, 2, 1, 3),
                            jnp.asarray(lengths)).reshape(B, 1, H, D)
    np.testing.assert_allclose(_np(out), _np(pallas), **_tol(dtype))
    np.testing.assert_allclose(_np(out), _np(oracle), **_tol(dtype))


def test_decode_attention_ring_window():
    """SWA ring cache: all slots valid once lengths >= window."""
    B, W, H, KV, D = 2, 256, 4, 4, 64
    rng = np.random.default_rng(2)
    (q, kc, vc), (jq, jkc, jvc) = _inputs(rng, "float32", (B, 1, H, D),
                                          (B, W, KV, D), (B, W, KV, D))
    lengths = np.array([W + 57, 100], np.int32)  # one wrapped, one not
    out = decode_attention(q, kc, vc, torch.from_numpy(lengths), window=W)
    pallas = jax_decode(jq, jkc, jvc, jnp.asarray(lengths), window=W,
                        interpret=True)
    np.testing.assert_allclose(_np(out), _np(pallas), rtol=2e-5, atol=2e-5)


def test_cpu_tensors_never_launch_a_kernel():
    before = (flash_attention.launches, decode_attention.launches)
    q = torch.randn(1, 16, 2, 16)
    flash_attention(q, q, q)
    decode_attention(q[:, :1], q, q, torch.tensor([5], dtype=torch.int32))
    assert (flash_attention.launches, decode_attention.launches) == before


# Edges of the card's wgmma path (bf16, 128-row tiles; head_dim 128, and 80,
# 96 and 112, whose second 64-column box is zero-filled past D): S below, at
# and past a tile, windows that end inside a tile, q scaled x8 (scores of
# standard deviation 8, reaching about +-60). Here the plain version runs; it
# is held to the JAX oracle in float32, so that the card tests, which hold
# the kernel to the plain version, rest on it.
@pytest.mark.parametrize("D", [80, 96, 112, 128])
@pytest.mark.parametrize("S", [1, 129])
@pytest.mark.parametrize("causal,window", [(True, None), (True, 64), (False, None)])
def test_flash_plain_matches_oracle_at_wgmma_edges(D, S, causal, window):
    (q, k, v), (jq, jk, jv) = _inputs(np.random.default_rng(5), "float32",
                                      (2, S, 8, D), (2, S, 2, D), (2, S, 2, D))
    out = flash_attention(8 * q, k, v, causal=causal, window=window)
    tr = lambda x: x.transpose(0, 2, 1, 3)
    oracle = tr(jax_flash_ref(tr(8 * jq), tr(jk), tr(jv), causal=causal,
                              window=window))
    np.testing.assert_allclose(_np(out), _np(oracle), **_tol("float32"))


def test_flash_check_refuses_misaligned_views():
    """TMA takes only 16-byte aligned addresses and strides: a contiguous
    view 4 bytes into its storage is refused before any launch."""
    from repro_torch.kernels.flash_attention.ops import _check
    n = 1 * 64 * 2 * 64
    q = torch.zeros(n + 4)[1:n + 1].view(1, 64, 2, 64)
    k = torch.zeros(1, 64, 2, 64)
    with pytest.raises(ValueError, match="16 bytes"):
        _check(q, k, k, None)
    with pytest.raises(ValueError, match="16 bytes"):
        _check(k, q, k, None)


@pytest.mark.parametrize("KV", [1, 2, 8])
@pytest.mark.parametrize("W", [1, 64, 300, 1024, 4096, 131072])
@pytest.mark.parametrize("sms", [66, 132])
def test_decode_split_plan_covers_the_cache(KV, W, sms):
    """Either kernel's splits (mma.sync, bulk.fma) cover the W slots with no
    split wholly past W, in whole 64-slot CTA passes (two 32-slot bulk.fma
    tiles), within the combine's 256 splits."""
    from repro_torch.kernels.decode_attention.ops import (MAX_SPLIT, PASS,
                                                          split_plan)
    chunk, n_split = split_plan(W, KV, sms)
    assert chunk % PASS == 0 and 1 <= n_split <= MAX_SPLIT
    assert (n_split - 1) * chunk < W <= n_split * chunk


def test_decode_split_plan_fills_the_card():
    """At Llama-3-8B's decode shape (8 slots, KV=8, W=4096) the grid gives
    every one of the H100's 132 SMs work even if only half the splits hold
    valid slots."""
    from repro_torch.kernels.decode_attention.ops import split_plan
    n_split = split_plan(4096, 8, sms=132)[1]
    assert 8 * 8 * n_split // 2 >= 132


def test_decode_check_refuses_misaligned_views():
    """cp.async takes only 16-byte aligned rows: a contiguous view 4 bytes
    into its storage is refused before any launch."""
    from repro_torch.kernels.decode_attention.ops import _check
    n = 1 * 64 * 2 * 64
    kc = torch.zeros(n + 4)[1:n + 1].view(1, 64, 2, 64)
    ok = torch.zeros(1, 64, 2, 64)
    q = torch.zeros(1, 1, 4, 64)
    lengths = torch.ones(1, dtype=torch.int32)
    with pytest.raises(ValueError, match="16 bytes"):
        _check(q, kc, ok, lengths, None)
    with pytest.raises(ValueError, match="16 bytes"):
        _check(q, ok, kc, lengths, None)


# The float32 flash kernels at D = 64..128 run on the tensor cores in TF32
# with every operand split into hi = tf32(x) and lo = tf32(x - hi) (3xTF32:
# a b = hi lo + lo hi + hi hi). The tensor core adds each k-step's products
# to its accumulator and truncates the sum toward zero, so a long chain of
# accumulations drifts: the kernels put lo-hi and hi-lo in an accumulator of
# their own, deal hi-hi over one or two chains (S, dP), and take each tile's
# P V, dS K, P^T dO and dS^T Q into a fresh accumulator added to the running
# sum in float32.
# These tests repeat that arithmetic on the CPU (exact products, sums
# truncated to float32 a k-step at a time) and hold it to the kernels'
# tolerances at the hardest case the card tests take (q x8: scores of about
# +-60): the forward at 2e-5, the gradients at 2e-4 of each gradient's
# largest magnitude, both against float64.
def _tf32(x):
    """float32 -> tf32 as cvt.rna.tf32.f32 rounds (finite inputs): to
    nearest, ties away from zero, the low 13 bits cleared."""
    return ((x.view(torch.int32) + 0x1000) & -0x2000).view(torch.float32)


def _rz(x):
    """float64 -> float32, truncated toward zero."""
    f = x.float()
    return torch.where(f.double().abs() > x.abs(),
                       torch.nextafter(f, torch.zeros_like(f)), f)


def _tc(a, b, chains, acc=None):
    """a @ b as the kernels issue it, a k-step of 8 at a time: chains = 0
    puts all three products into one accumulator (``acc`` continues it);
    otherwise lo-hi and hi-lo go to one accumulator and hi-hi to ``chains``
    by k-step, added in float32 at the end."""
    ah, bh = _tf32(a), _tf32(b)
    al, bl = _tf32(a - ah), _tf32(b - bh)
    z = torch.zeros(a.shape[:-1] + b.shape[-1:])
    sm, hh = z, [z] * max(chains, 1)
    if acc is not None:
        hh[0] = acc
    for i, k in enumerate(range(0, a.shape[-1], 8)):
        s = slice(k, k + 8)
        wg = lambda c, x, y: _rz(c.double() + x[..., s].double() @ y[..., s, :].double())
        if chains == 0:
            hh[0] = wg(wg(wg(hh[0], ah, bl), al, bh), ah, bh)
        else:
            sm = wg(wg(sm, ah, bl), al, bh)
            hh[i % chains] = wg(hh[i % chains], ah, bh)
    out = hh[0]
    for c in hh[1:] + ([sm] if chains else []):
        out = out + c
    return out


def _attention_as_kernels(q, k, v, do, tile=32, dq_tile=None, fwd_tile=None):
    """Causal forward (online softmax over key tiles of ``fwd_tile``) and
    backward (dK/dV over query steps of ``tile``, dQ over key tiles of
    ``dq_tile``; ``fwd_tile`` and ``dq_tile`` are ``tile`` by default),
    each step's or tile's product apart, with the kernels' products;
    (B, H, S, D), k and v of KV heads."""
    B, H, S, D = q.shape
    G = H // k.shape[1]
    kr, vr = k.repeat_interleave(G, 1), v.repeat_interleave(G, 1)
    scale = 1.0 / np.sqrt(D)
    pos = torch.arange(S)
    mask = pos[None, :] <= pos[:, None]
    s = (_tc(q, kr.transpose(-1, -2), 2) * scale).masked_fill(~mask, -np.inf)
    m = torch.full((B, H, S, 1), -np.inf)
    l, o = torch.zeros(B, H, S, 1), torch.zeros(B, H, S, D)
    fwd_tile = fwd_tile or tile
    for k0 in range(0, S, fwd_tile):
        mn = torch.maximum(m, s[..., k0:k0 + fwd_tile].amax(-1, keepdim=True))
        p = torch.exp(s[..., k0:k0 + fwd_tile] - mn)
        alpha = torch.exp(m - mn)
        l = l * alpha + p.sum(-1, keepdim=True)
        o = o * alpha + _tc(p, vr[..., k0:k0 + fwd_tile, :], 0)
        m = mn
    o, lse = o / l, m + torch.log(l)
    dsT = _tc(kr, q.transpose(-1, -2), 1) * scale
    pT = torch.where(mask.T, torch.exp(dsT - lse.transpose(-1, -2)), 0.0)
    dpT = _tc(vr, do.transpose(-1, -2), 1)
    dsT = pT * (dpT - (do * o).sum(-1)[..., None, :])
    dq = torch.zeros_like(q)
    dq_tile = dq_tile or tile
    for k0 in range(0, S, dq_tile):
        dq = dq + _tc(dsT[..., k0:k0 + dq_tile, :].transpose(-1, -2),
                      kr[..., k0:k0 + dq_tile, :], 0)
    dkv = []
    for a, b in ((dsT, q), (pT, do)):
        a = a.reshape(B, -1, G, S, S).permute(0, 1, 3, 2, 4).reshape(B, -1, S, G * S)
        b = b.reshape(B, -1, G, S, D).reshape(B, -1, G * S, D)
        acc = torch.zeros(a.shape[:-1] + (D,))
        for q0 in range(0, G * S, tile):
            acc = acc + _tc(a[..., q0:q0 + tile], b[..., q0:q0 + tile, :], 0)
        dkv.append(acc)
    return o, (dq * scale, dkv[0] * scale, dkv[1])


def _attention_f64(q, k, v, do):
    """The same causal attention and gradients in float64, by autograd."""
    B, H, S, D = q.shape
    G = H // k.shape[1]
    q, k, v = (x.double().requires_grad_() for x in (q, k, v))
    s = q @ k.repeat_interleave(G, 1).transpose(-1, -2) / np.sqrt(D)
    s = s.masked_fill(~(torch.arange(S)[None, :] <= torch.arange(S)[:, None]), -np.inf)
    o = torch.softmax(s, -1) @ v.repeat_interleave(G, 1)
    return o.detach(), torch.autograd.grad(o, (q, k, v), do.double())


# The tiles the mirror takes below D = 64, as ``ops.tf32_plan`` gives them:
# the forward's key tile (fwd_keys), the backward's dK/dV query step
# (dkdv_queries) and dQ key tile (dq_keys); 64 and 128 keep the mirror's
# default.
TF32_SMALL_TILES = {16: (128, 64, 64), 32: (128, 64, 64), 48: (64, 48, 32)}


@pytest.mark.parametrize("D", [16, 32, 48, 64, 128])
def test_tf32x3_split_meets_float32_tolerances(D):
    rng = np.random.default_rng(D)
    B, H, KV, S = 1, 4, 2, 256
    q, k, v, do = (torch.from_numpy(rng.standard_normal(s, dtype=np.float32))
                   for s in ((B, H, S, D), (B, KV, S, D), (B, KV, S, D),
                             (B, H, S, D)))
    q = q * 8
    fwd_tile, tile, dq_tile = TF32_SMALL_TILES.get(D, (32, 32, 32))
    o, grads = _attention_as_kernels(q, k, v, do, tile=tile, dq_tile=dq_tile,
                                     fwd_tile=fwd_tile)
    o64, want = _attention_f64(q, k, v, do)
    np.testing.assert_allclose(o.double().numpy(), o64.numpy(), rtol=2e-5, atol=2e-5)
    largest = max(float(w.abs().max()) for w in want)
    for got, w in zip(grads, want):
        scale = max(float(w.abs().max()), 1e-2 * largest)
        assert float((got.double() - w).abs().max()) / scale <= 2e-4
