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
    """The mma.sync kernel's splits cover the W slots with no split wholly
    past W, in whole 64-slot CTA passes, within the combine's 256 splits."""
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
