"""The port's CUDA kernels on the card, against their plain versions.

Every test here is marked ``cuda`` and skips inside the test when no card is
present. The file imports neither ``jax`` nor ``repro``, so it runs on a
machine with the card and PyTorch only:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_card.py

The shape sweeps are those of ``tests/test_kernels.py``; tolerances are the
same (attention: float32 2e-5, bfloat16 2e-2; gla_scan: float32 2e-4,
bfloat16 5e-2).
"""
import numpy as np
import pytest
import torch

from repro_torch.configs import get_config, reduced_config
from repro_torch.kernels.decode_attention import (decode_attention,
                                                  decode_attention_reference)
from repro_torch.kernels.decode_attention.ops import kernel_route, split_plan
from repro_torch.kernels.flash_attention import (
    FlashAttention, attention_backward_reference, attention_forward_reference,
    attention_reference, flash_attention, flash_attention_bwd,
    flash_attention_fwd)
from repro_torch.kernels.flash_attention.ops import \
    kernel_route as flash_route
from repro_torch.kernels.flash_attention.ops import \
    tf32_plan as flash_tf32_plan
from repro_torch.kernels.gla_scan import gla_scan, gla_scan_reference
from repro_torch.kernels.gla_scan import ops as gla_ops
from repro_torch.kernels.gla_scan.ops import kernel_route as gla_route
from repro_torch.models import build_model

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
REF_DTYPE = {"float32": torch.float64, "bfloat16": torch.bfloat16}
FLASH_SHAPES = [(1, 128, 4, 4, 64), (2, 256, 4, 2, 64),
                (1, 200, 8, 1, 32),   # unpadded seq, MQA
                (2, 64, 6, 3, 80)]    # odd heads / head_dim
FLASH_MASKS = [(True, None), (True, 64), (False, None)]
# The wgmma paths, at every head dim from 16 to 128 (bf16: one 64-column box
# per tile row up to 64, zero-filled past D below 64, two at the others, the
# second zero-filled past D below 128; float32 in TF32 with the 3xTF32
# split: 32-column boxes, one to four a row, the last zero-filled past D
# where D is not a multiple of 32, key tiles as ``ops.tf32_plan`` gives
# them):
# S on both sides of the 64-row consumer and 128-row tiles, batch 1 and 2,
# GQA groups 1, 4 and 8 of H = 8, causal, windows 64 and 1000, non-causal;
# q scaled x8 as well, so that scores (standard deviation 8) reach about
# +-60 and exercise the exp2 rescaling. Below D = 64, float32 also at the
# small head dims' timed shape (B=1 S=2048 GQA 32/8 causal).
WGMMA_D = [64, 80, 96, 112, 128]
SMALL_D = [16, 32, 48]
WGMMA_S = [1, 63, 64, 127, 128, 129, 1000, 2048]
WGMMA_MASKS = [(True, None), (True, 64), (True, 1000), (False, None)]
# (B, S, H, KV, D, dtype, causal, window, amp): amp scales q
FLASH_CASES = (
    [(B, S, H, KV, D, dtype, causal, window, 1)
     for B, S, H, KV, D in FLASH_SHAPES for dtype in DTYPES
     for causal, window in FLASH_MASKS]
    + [(B, S, 8, 8 // group, D, dtype, causal, window, amp)
       for dtype in ("bfloat16", "float32")
       for D in SMALL_D + WGMMA_D for S in WGMMA_S for B in (1, 2)
       for group in (1, 4, 8) for causal, window in WGMMA_MASKS
       for amp in (1, 8)]
    + [(1, 2048, 32, 8, D, "float32", True, None, amp) for D in SMALL_D
       for amp in (1, 8)])
DECODE_SHAPES = [(2, 512, 8, 2, 64), (1, 1024, 4, 4, 128), (3, 300, 6, 3, 80)]
# The decode mma.sync path (bf16 q and cache; the served head dims 64 and 128
# here, the others below): W = 1024, KV = 2, G = H / KV of 1, 2, 4 and 8,
# B 1 and 8. The first sequence's length sits on both sides of a warp tile
# (16 slots), a CTA pass (64) and a split (128 slots at W = 1024), at W, past
# W in a ring of window W, and past a window of 500 inside W; the other
# sequences take random lengths. q is scaled x8 as well, so that scores reach
# about +-40 and exercise the rescaling across tiles, warps and splits.
DECODE_W = 1024
DECODE_LENGTHS = [(1, None), (15, None), (17, None), (63, None), (65, None),
                  (127, None), (129, None), (1024, None), (1324, 1024),
                  (900, 500)]
# the other bf16 head dims, which take the same kernel
DECODE_OTHER_D = [16, 32, 48, 80, 96, 112]
DECODE_OTHER_LENGTHS = [(1, None), (17, None), (129, None), (1024, None),
                        (1324, 1024)]
GLA_SHAPES = [(1, 64, 2, 32, 32), (2, 130, 2, 64, 64), (1, 256, 4, 16, 64)]
# The bf16 gla_scan path (tensor cores, 64-token chunks of four 16-token
# sub-chunks): T on both sides of a sub-chunk and a chunk, and the served
# lengths; K = V = 16 and 64, and K = 32 with V = 64; B 1 and 2.
GLA_MMA_T = [1, 15, 16, 63, 64, 65, 1000, 2048]
GLA_MMA_KV = [(16, 16), (64, 64), (32, 64)]


def _cuda_or_skip():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


def _tol(dtype):
    return dict(rtol=2e-2, atol=2e-2) if dtype == "bfloat16" \
        else dict(rtol=2e-5, atol=2e-5)


def _inputs(rng, dtype, *shapes):
    """Normal draws from numpy, rounded to ``dtype``, on the card."""
    return [torch.from_numpy(rng.standard_normal(s, dtype=np.float32))
            .to(DTYPES[dtype]).cuda() for s in shapes]


def _np(x):
    return x.float().cpu().numpy()


def _flash_id(case):
    B, S, H, KV, D, dtype, causal, window, amp = case
    return (f"B{B}-S{S}-H{H}-KV{KV}-D{D}-{dtype}-"
            f"{'causal' if causal else 'full'}-w{window}-x{amp}")


def _flash_inputs(seed, B, S, H, KV, D, dtype, amp=1):
    q, k, v = _inputs(np.random.default_rng(seed), dtype, (B, S, H, D),
                      (B, S, KV, D), (B, S, KV, D))
    return q * amp, k, v


@pytest.mark.cuda
@pytest.mark.parametrize("B,S,H,KV,D,dtype,causal,window,amp", FLASH_CASES,
                         ids=[_flash_id(c) for c in FLASH_CASES])
def test_flash_kernel_matches_plain_on_card(B, S, H, KV, D, dtype, causal,
                                            window, amp):
    _cuda_or_skip()
    _flash_cases_hold(B, S, H, KV, D, dtype, causal, window, amp)


def _flash_cases_hold(B, S, H, KV, D, dtype, causal, window, amp):
    q, k, v = _flash_inputs(0, B, S, H, KV, D, dtype, amp)
    n = flash_attention.launches
    out = flash_attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert flash_attention.launches == n + 1
    tr = lambda x: x.transpose(1, 2)
    # float32 kernels against the plain version evaluated in float64: at
    # scores of +-60 (q x8) float32's own rounding of the plain version
    # reaches the 2e-5 tolerance
    q, k, v = (tr(x).to(REF_DTYPE[dtype]) for x in (q, k, v))
    ref = tr(attention_reference(q, k, v, causal=causal, window=window))
    np.testing.assert_allclose(_np(out), ref.double().cpu().numpy(),
                               **_tol(dtype))


@pytest.mark.cuda
@pytest.mark.parametrize("amp", [1, 8])
def test_flash_kernel_matches_plain_at_hubert_shape_on_card(amp):
    """HuBERT-XLarge's encoder as served: B=4, S=1024, 16 heads of 80,
    non-causal, on the wgmma path."""
    _cuda_or_skip()
    assert flash_route(torch.bfloat16, 80)[0] == "wgmma"
    _flash_cases_hold(4, 1024, 16, 16, 80, "bfloat16", False, None, amp)


@pytest.mark.cuda
def test_flash_routes_by_dtype_and_head_dim_on_card():
    """bf16 at every head dim takes the TMA + wgmma kernel, float32 the TMA
    + wgmma kernel in 3xTF32, both ways; a head dim off the grid of 16
    none."""
    _cuda_or_skip()
    for D in SMALL_D + WGMMA_D:
        assert flash_route(torch.bfloat16, D)[0] == "wgmma"
        for backward in (False, True):
            assert flash_route(torch.float32, D, backward)[0] == "wgmma.3xtf32"
    # below D = 64 the CPU mirror of the 3xTF32 arithmetic takes these tiles
    # (tests/test_torch_kernels.py::TF32_SMALL_TILES)
    assert {D: tuple(flash_tf32_plan(D)[k] for k in ("fwd_keys", "dkdv_queries",
                                                      "dq_keys"))
            for D in SMALL_D} == {16: (128, 64, 64), 32: (128, 64, 64),
                                  48: (64, 48, 32)}
    assert flash_route(torch.bfloat16, 72)[0] is None
    assert flash_route(torch.float32, 72)[0] is None
    # up to D = 64 a tile is one 64-column box, from 80 to 128 two: D = 64's
    # and D = 128's shared memory
    assert len({flash_route(torch.bfloat16, D)[1] for D in SMALL_D + [64]}) == 1
    assert len({flash_route(torch.bfloat16, D)[1] for D in WGMMA_D[1:]}) == 1


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("D", SMALL_D + WGMMA_D)
def test_flash_kernel_is_deterministic_on_card(D, dtype):
    """Two launches on the same input give the same bits."""
    _cuda_or_skip()
    q, k, v = _flash_inputs(4, 2, 1000, 8, 2, D, dtype, 8)
    a = flash_attention(q, k, v, causal=True, window=None)
    b = flash_attention(q, k, v, causal=True, window=None)
    torch.cuda.synchronize()
    assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("D", SMALL_D + [64, 128])
def test_flash_forward_replays_from_cuda_graph_on_card(D, dtype):
    """The forward with lse captured in a CUDA graph replays to the eager
    call's bits and reads the captured q anew after an in-place change."""
    _cuda_or_skip()
    q, k, v = _flash_inputs(11, 2, 1000, 6, 2, D, dtype)
    q2 = _inputs(np.random.default_rng(12), dtype, (2, 1000, 6, D))[0]
    want = flash_attention_fwd(q, k, v, causal=True)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        got = flash_attention_fwd(q, k, v, causal=True)
    graph.replay()
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    q.copy_(q2)
    graph.replay()
    want2 = flash_attention_fwd(q2, k, v, causal=True)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(got, want2))
    assert not torch.equal(want2[0], want[0])


# The backward kernels (and the forward's lse): every head dim the forward
# takes, float32 (3xTF32 wgmma) and bf16 (wgmma); GQA
# groups 1, 3 and 6 of H = 6; S of 1, on both sides of a 64-row tile (the
# dK/dV item's keys) and a 128-row one (the dQ item's queries and keys),
# 200 and 257 (S % 4 != 0: lse and delta rows start unaligned); causal,
# window 64 and 100 (not a multiple of a tile), non-causal, non-causal with
# a window of 50. Gradients within 2e-4 (float32)
# or 2e-2 (bf16) of each gradient's largest magnitude, against the plain
# backward fed the kernel forward's own o and lse; a gradient that cancels to
# rounding noise (dq and dk are 0 at S = 1) is held at 1e-2 of the largest
# magnitude of the three.
BWD_D = [16, 32, 48, 64, 80, 96, 112, 128]
BWD_S = [1, 63, 65, 127, 128, 129, 200, 257]
BWD_MASKS = [(True, None), (True, 64), (True, 100), (False, None), (False, 50)]
BWD_TOL = {"float32": 2e-4, "bfloat16": 2e-2}
LSE_TOL = {"float32": 1e-5, "bfloat16": 1e-3}


def _bwd_case_hold(seed, B, S, H, KV, D, dtype, causal, window, amp=1,
                   ref_dtype=None, lse_tol=None):
    """``ref_dtype``: the forward's o and lse are held against the plain
    forward evaluated in it (float64 for float32 at scores of +-60, where
    float32's own rounding of the plain version reaches the tolerance);
    ``lse_tol``: lse's absolute tolerance, LSE_TOL[dtype] by default."""
    q, k, v = _flash_inputs(seed, B, S, H, KV, D, dtype, amp)
    do = _inputs(np.random.default_rng(seed + 1), dtype, (B, S, H, D))[0]
    tr = lambda x: x.transpose(1, 2)
    n_fwd, n_bwd = flash_attention.launches, flash_attention_bwd.launches
    out, lse = flash_attention_fwd(q, k, v, causal=causal, window=window)
    grads = flash_attention_bwd(q, k, v, out, lse, do, causal=causal,
                                window=window)
    torch.cuda.synchronize()
    assert (flash_attention.launches, flash_attention_bwd.launches) == (
        n_fwd + 1, n_bwd + 1)
    wide = (lambda x: x.to(ref_dtype)) if ref_dtype else (lambda x: x)
    ref_out, ref_lse = attention_forward_reference(
        *(wide(tr(x)) for x in (q, k, v)), causal=causal, window=window)
    np.testing.assert_allclose(_np(out), tr(ref_out).double().cpu().numpy(),
                               **_tol(dtype))
    np.testing.assert_allclose(_np(lse), ref_lse.double().cpu().numpy(),
                               rtol=0, atol=lse_tol or LSE_TOL[dtype])
    refs = attention_backward_reference(tr(q), tr(k), tr(v), tr(out), lse,
                                        tr(do), causal=causal, window=window)
    largest = max(float(r.abs().max()) for r in refs)
    for name, got, want in zip("qkv", grads, refs):
        want = tr(want).float()
        scale = max(float(want.abs().max()), 1e-2 * largest)
        err = float((got.float() - want).abs().max())
        assert torch.isfinite(got).all() and err <= BWD_TOL[dtype] * scale, (
            f"d{name}: max err {err:.3e} of max |ref| {scale:.3e}")
    return grads


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("D", BWD_D)
@pytest.mark.parametrize("S", BWD_S)
@pytest.mark.parametrize("causal,window", BWD_MASKS)
@pytest.mark.parametrize("KV", [6, 2, 1])
def test_flash_backward_matches_plain_on_card(dtype, D, S, causal, window, KV):
    _cuda_or_skip()
    _bwd_case_hold(7, 2, S, 6, KV, D, dtype, causal, window)


@pytest.mark.cuda
@pytest.mark.parametrize("B,S,H,KV,D,causal,window", [
    (8, 2048, 15, 5, 64, True, None),      # smollm-360m's training shape
    (1, 2048, 32, 8, 128, True, None),     # Llama widths
    (1, 2048, 32, 8, 80, True, 1000),      # D = 80 with a window inside S
    (2, 1000, 15, 3, 64, True, None)])     # G = 5, B = 2: TMA's fill past S
                                           # must not read the next sequence
@pytest.mark.parametrize("amp", [1, 8])
def test_flash_backward_matches_plain_at_training_shapes_on_card(
        B, S, H, KV, D, causal, window, amp):
    _cuda_or_skip()
    _bwd_case_hold(3, B, S, H, KV, D, "bfloat16", causal, window, amp)


@pytest.mark.cuda
@pytest.mark.parametrize("B,S,H,KV", [
    (1, 2048, 32, 8),      # the small head dims' timed shape
    (2, 1000, 15, 3)])     # G = 5, B = 2: TMA's fill past S
@pytest.mark.parametrize("D", SMALL_D)
@pytest.mark.parametrize("amp", [1, 8])
def test_flash_f32_backward_matches_plain_at_small_head_dims_on_card(
        B, S, H, KV, D, amp):
    """float32 below D = 64 at long sequences: the 3xTF32 backward kernels
    (64-key dK/dV items) against the plain backward, scores up to +-60 at
    amp 8; the 3xTF32 forward's o and lse against the plain forward in
    float64. lse is held at 1e-5 per unit of the scores' standard
    deviation (amp): its error is float32's rounding of the scores, which
    grows with them (at amp 8 and |lse| ~30 a float32 forward's lse sat
    1.1e-5 to 1.5e-5 off float64's, ~8 float32 ulps, on an H100)."""
    _cuda_or_skip()
    for backward in (False, True):
        assert flash_route(torch.float32, D, backward)[0] == "wgmma.3xtf32"
    _bwd_case_hold(3, B, S, H, KV, D, "float32", True, None, amp,
                   ref_dtype=torch.float64, lse_tol=LSE_TOL["float32"] * amp)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("D", SMALL_D + [64, 80, 128])
def test_flash_backward_is_deterministic_on_card(dtype, D):
    """No atomics: two backward launches on the same inputs give the same
    bits, and so do two forwards' lse."""
    _cuda_or_skip()
    q, k, v = _flash_inputs(5, 2, 1000, 8, 2, D, dtype, 8)
    do = _inputs(np.random.default_rng(6), dtype, (2, 1000, 8, D))[0]
    out, lse = flash_attention_fwd(q, k, v, causal=True)
    out2, lse2 = flash_attention_fwd(q, k, v, causal=True)
    a = flash_attention_bwd(q, k, v, out, lse, do, causal=True)
    b = flash_attention_bwd(q, k, v, out, lse, do, causal=True)
    torch.cuda.synchronize()
    assert torch.equal(out, out2) and torch.equal(lse, lse2)
    assert all(torch.equal(x, y) for x, y in zip(a, b))


@pytest.mark.cuda
def test_flash_autograd_function_on_card():
    """FlashAttention.apply through autograd: the forward with lse and the
    backward kernels launch once each, an expanded output gradient (sum's)
    is made contiguous, and the gradients equal a direct backward call."""
    _cuda_or_skip()
    q, k, v = (x.requires_grad_() for x in
               _flash_inputs(8, 1, 300, 4, 2, 64, "bfloat16"))
    n_fwd, n_bwd = flash_attention.launches, flash_attention_bwd.launches
    out = FlashAttention.apply(q, k, v, True, None)
    out.float().sum().backward()
    torch.cuda.synchronize()
    assert (flash_attention.launches, flash_attention_bwd.launches) == (
        n_fwd + 1, n_bwd + 1)
    o, lse = flash_attention_fwd(q.detach(), k.detach(), v.detach())
    want = flash_attention_bwd(q.detach(), k.detach(), v.detach(), o, lse,
                               torch.ones_like(o))
    for x, w in zip((q, k, v), want):
        assert torch.equal(x.grad, w)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("D", SMALL_D + [64, 128])
def test_flash_backward_replays_from_cuda_graph_on_card(D, dtype):
    """The backward captured in a CUDA graph (its tensor maps are kernel
    arguments, encoded at capture) replays to the eager call's bits, and
    reads the captured inputs anew: after an in-place change of dO a replay
    equals an eager call on the new dO."""
    _cuda_or_skip()
    q, k, v = _flash_inputs(9, 2, 1000, 6, 2, D, dtype)
    rng = np.random.default_rng(10)
    do, do2 = _inputs(rng, dtype, (2, 1000, 6, D), (2, 1000, 6, D))
    out, lse = flash_attention_fwd(q, k, v, causal=True)
    want = flash_attention_bwd(q, k, v, out, lse, do, causal=True)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        got = flash_attention_bwd(q, k, v, out, lse, do, causal=True)
    graph.replay()
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    do.copy_(do2)
    graph.replay()
    want2 = flash_attention_bwd(q, k, v, out, lse, do2, causal=True)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(got, want2))
    assert not torch.equal(want2[0], want[0])


@pytest.mark.cuda
def test_flash_backward_routes_on_card():
    """bf16 at every head dim takes the TMA + wgmma kernels, float32 the TMA
    + wgmma kernels in 3xTF32."""
    _cuda_or_skip()
    for D in BWD_D:
        assert flash_route(torch.bfloat16, D, backward=True)[0] == "wgmma"
        assert flash_route(torch.float32, D, backward=True)[0] == "wgmma.3xtf32"
    assert flash_route(torch.bfloat16, 72, backward=True)[0] is None
    assert flash_route(torch.float32, 72, backward=True)[0] is None


@pytest.mark.cuda
@pytest.mark.parametrize("D", [32, 80, 128])
def test_flash_wrapper_refuses_misaligned_views_on_card(D):
    """A view 2 bytes into its storage is contiguous but not 16-byte
    aligned, which TMA cannot take: the wrapper raises before any launch."""
    _cuda_or_skip()
    B, S, H = 1, 64, 2
    n = B * S * H * D
    q = torch.zeros(n + 8, dtype=torch.bfloat16, device="cuda")[1:n + 1]
    q = q.view(B, S, H, D)
    k = torch.zeros(B, S, H, D, dtype=torch.bfloat16, device="cuda")
    launches = flash_attention.launches
    with pytest.raises(ValueError, match="16 bytes"):
        flash_attention(q, k, k)
    assert flash_attention.launches == launches


@pytest.mark.cuda
def test_flash_wrapper_refuses_misaligned_float32_view_on_card():
    """The float32 TMA route at D = 64: a view one float into its storage
    is refused before any launch, forward and backward."""
    _cuda_or_skip()
    B, S, H, D = 1, 64, 2, 64
    n = B * S * H * D
    q = torch.zeros(n + 4, dtype=torch.float32, device="cuda")[1:n + 1]
    q = q.view(B, S, H, D)
    k = torch.zeros(B, S, H, D, dtype=torch.float32, device="cuda")
    lse = torch.zeros(B, H, S, dtype=torch.float32, device="cuda")
    launches = flash_attention.launches, flash_attention_bwd.launches
    with pytest.raises(ValueError, match="16 bytes"):
        flash_attention(q, k, k)
    with pytest.raises(ValueError, match="16 bytes"):
        flash_attention_bwd(q, k, k, k, lse, k)
    assert (flash_attention.launches, flash_attention_bwd.launches) == launches


@pytest.mark.cuda
@pytest.mark.parametrize("B,W,H,KV,D", DECODE_SHAPES)
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("window", [None, 64])
def test_decode_kernel_matches_plain_on_card(B, W, H, KV, D, dtype, window):
    _cuda_or_skip()
    rng = np.random.default_rng(1)
    q, kc, vc = _inputs(rng, dtype, (B, 1, H, D), (B, W, KV, D), (B, W, KV, D))
    lengths = torch.from_numpy(rng.integers(1, W + 1, B).astype(np.int32)).cuda()
    n = decode_attention.launches
    out = decode_attention(q, kc, vc, lengths, window=window)
    torch.cuda.synchronize()
    assert decode_attention.launches == n + 1
    ref = decode_attention_reference(
        q.reshape(B, KV, H // KV, D), kc.transpose(1, 2), vc.transpose(1, 2),
        lengths, window=window).reshape(B, 1, H, D)
    np.testing.assert_allclose(_np(out), _np(ref), **_tol(dtype))


@pytest.mark.cuda
@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("G", [1, 2, 4, 8])
@pytest.mark.parametrize("B", [1, 8])
@pytest.mark.parametrize("length,window", DECODE_LENGTHS)
@pytest.mark.parametrize("amp", [1, 8])
def test_decode_mma_kernel_matches_plain_on_card(D, G, B, length, window, amp):
    _check_decode_mma(D, G, B, length, window, amp)


@pytest.mark.cuda
@pytest.mark.parametrize("D", DECODE_OTHER_D)
@pytest.mark.parametrize("G", [1, 8])
@pytest.mark.parametrize("B", [1, 8])
@pytest.mark.parametrize("length,window", DECODE_OTHER_LENGTHS)
@pytest.mark.parametrize("amp", [1, 8])
def test_decode_mma_kernel_other_head_dims_on_card(D, G, B, length, window,
                                                   amp):
    """Every bf16 head dim (a multiple of 16 up to 128) takes the mma.sync
    kernel, not only the served 64 and 128."""
    _check_decode_mma(D, G, B, length, window, amp)


def _check_decode_mma(D, G, B, length, window, amp):
    _cuda_or_skip()
    assert kernel_route(torch.bfloat16, torch.bfloat16, D)[0] == "mma.sync"
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    assert split_plan(DECODE_W, 2, sms)[0] == 128  # the split edge above
    rng = np.random.default_rng(length + 7 * G + B)
    H, KV = 2 * G, 2
    q, kc, vc = _inputs(rng, "bfloat16", (B, 1, H, D), (B, DECODE_W, KV, D),
                        (B, DECODE_W, KV, D))
    q = q * amp
    lengths = rng.integers(1, DECODE_W + 1, B).astype(np.int32)
    lengths[0] = length
    lengths = torch.from_numpy(lengths).cuda()
    n = decode_attention.launches
    out = decode_attention(q, kc, vc, lengths, window=window)
    torch.cuda.synchronize()
    assert decode_attention.launches == n + 1
    assert out.dtype == torch.bfloat16 and torch.isfinite(out.float()).all()
    ref = decode_attention_reference(
        q.reshape(B, KV, G, D), kc.transpose(1, 2), vc.transpose(1, 2),
        lengths, window=window).reshape(B, 1, H, D)
    np.testing.assert_allclose(_np(out), _np(ref), **_tol("bfloat16"))
    _assert_within_sequence_scale(out, ref)


def _assert_within_sequence_scale(out, ref, tol=2e-2):
    """Each sequence's worst error within ``tol`` of its largest |output|.
    A decode output averages up to thousands of V rows, so at q x1 its
    values fall below bf16's atol of 2e-2: this holds them to their own
    scale, where a dropped split or an unrescaled partial shows."""
    a, b = out.float().flatten(1), ref.float().flatten(1)
    err = (a - b).abs().amax(1) / b.abs().amax(1)
    assert float(err.max()) <= tol, err.tolist()


@pytest.mark.cuda
@pytest.mark.parametrize("window,top", [(None, 4096), (4096, 8000)])
@pytest.mark.parametrize("amp", [1, 8])
def test_decode_mma_kernel_matches_plain_at_the_served_shape_on_card(
        window, top, amp):
    """Llama-3-8B's decode shape (8 sequences, W = 4096, H = 32, KV = 8,
    D = 128), lengths 1..4096 or a wrapped ring up to 8000: eight 512-slot
    splits per sequence, combined by the last to arrive."""
    _cuda_or_skip()
    B, W, H, KV, D = 8, 4096, 32, 8, 128
    q, kc, vc = _inputs(np.random.default_rng(12 + amp), "bfloat16",
                        (B, 1, H, D), (B, W, KV, D), (B, W, KV, D))
    q = q * amp
    lengths = torch.linspace(1, top, B).round().int().cuda()
    out = decode_attention(q, kc, vc, lengths, window=window)
    ref = decode_attention_reference(
        q.reshape(B, KV, H // KV, D), kc.transpose(1, 2), vc.transpose(1, 2),
        lengths, window=window).reshape(B, 1, H, D)
    np.testing.assert_allclose(_np(out), _np(ref), **_tol("bfloat16"))
    _assert_within_sequence_scale(out, ref)


@pytest.mark.cuda
def test_decode_mma_kernel_is_deterministic_on_card():
    """Splits combine in split order, whichever finishes last: two launches
    on the same input give the same bits (Llama-3-8B's decode shape)."""
    _cuda_or_skip()
    B, W, H, KV, D = 8, 4096, 32, 8, 128
    q, kc, vc = _inputs(np.random.default_rng(6), "bfloat16", (B, 1, H, D),
                        (B, W, KV, D), (B, W, KV, D))
    lengths = torch.linspace(1, W, B).round().int().cuda()
    a = decode_attention(q, kc, vc, lengths)
    b = decode_attention(q, kc, vc, lengths)
    torch.cuda.synchronize()
    assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("D", [64, 128])
def test_decode_mma_kernel_is_batch_invariant_on_card(D):
    """A sequence's output does not depend on the batch it shares a launch
    with: the serving engine decodes every slot, and its tokens must equal a
    loop over one sequence (chip_smoke.py phase 6)."""
    _cuda_or_skip()
    B, W, H, KV = 8, 4096, 32, 8
    q, kc, vc = _inputs(np.random.default_rng(8), "bfloat16", (B, 1, H, D),
                        (B, W, KV, D), (B, W, KV, D))
    lengths = torch.tensor([513, 1, 1, 1, 2000, 1, 1, 4096],
                           dtype=torch.int32).cuda()
    full = decode_attention(q, kc, vc, lengths)
    for b in (0, 4, 7):
        one = decode_attention(q[b:b + 1].contiguous(), kc[b:b + 1].contiguous(),
                               vc[b:b + 1].contiguous(), lengths[b:b + 1].contiguous())
        torch.cuda.synchronize()
        assert torch.equal(one, full[b:b + 1])


@pytest.mark.cuda
def test_decode_mma_kernel_replays_from_a_cuda_graph_on_card():
    """The combine's tickets are left at zero by every launch, so replays of
    a captured call give the eager result each time."""
    _cuda_or_skip()
    B, W, H, KV, D = 8, 2048, 32, 8, 128
    q, kc, vc = _inputs(np.random.default_rng(10), "bfloat16", (B, 1, H, D),
                        (B, W, KV, D), (B, W, KV, D))
    lengths = torch.linspace(1, W, B).round().int().cuda()
    eager = decode_attention(q, kc, vc, lengths)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = decode_attention(q, kc, vc, lengths)
    for _ in range(3):
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out, eager)


@pytest.mark.cuda
def test_decode_wrapper_refuses_misaligned_views_on_card():
    """A cache view 2 bytes into its storage is contiguous but not 16-byte
    aligned, which cp.async cannot take: the wrapper raises before any
    launch."""
    _cuda_or_skip()
    B, W, KV, D = 1, 64, 2, 128
    n = B * W * KV * D
    kc = torch.zeros(n + 8, dtype=torch.bfloat16, device="cuda")[1:n + 1]
    kc = kc.view(B, W, KV, D)
    vc = torch.zeros(B, W, KV, D, dtype=torch.bfloat16, device="cuda")
    q = torch.zeros(B, 1, 2 * KV, D, dtype=torch.bfloat16, device="cuda")
    lengths = torch.full((B,), 10, dtype=torch.int32, device="cuda")
    launches = decode_attention.launches
    with pytest.raises(ValueError, match="16 bytes"):
        decode_attention(q, kc, vc, lengths)
    assert decode_attention.launches == launches


@pytest.mark.cuda
def test_engine_kernels_match_einsum_on_card():
    """On the card: the kernel path launches both kernels and agrees with the
    plain einsum path on the reduced model in float32."""
    _cuda_or_skip()
    cfg = reduced_config(get_config("llama3-8b")).replace(dtype="float32")
    params = build_model(cfg).init(0, device="cuda")
    prompt = torch.arange(1, 13, device="cuda")[None]
    outs = {}
    for impl in ("kernel", "einsum"):
        model = build_model(cfg, attn_impl=impl)
        launches = (flash_attention.launches, decode_attention.launches)
        logits, cache = model.prefill(params, {"tokens": prompt}, 64)
        for _ in range(3):
            tok = torch.argmax(logits, -1)[:, None]
            logits, cache = model.decode_step(params, {"tokens": tok}, cache)
        outs[impl] = logits.float().cpu()
        launched = (flash_attention.launches - launches[0],
                    decode_attention.launches - launches[1])
        assert launched == ((cfg.n_layers, 3 * cfg.n_layers) if impl == "kernel"
                            else (0, 0))
    torch.testing.assert_close(outs["kernel"], outs["einsum"], rtol=1e-4,
                               atol=1e-4)


def _gla_inputs(seed, dtype, B, T, H, K, V, mode, lw_dtype=None):
    """q/k/v normal; log w = -exp(U(-6, 2.5)), the sweep's strong decay
    (|log w| up to 12 per token); u for rwkv. All on the card."""
    rng = np.random.default_rng(seed)
    q, k, v = _inputs(rng, dtype, (B, T, H, K), (B, T, H, K), (B, T, H, V))
    lw = torch.from_numpy(-np.exp(rng.uniform(-6.0, 2.5, (B, T, H, K)))
                          .astype(np.float32)).to(lw_dtype or DTYPES[dtype]).cuda()
    u = _inputs(rng, dtype, (H, K))[0] * 0.3 if mode == "rwkv" else None
    return q, k, v, lw, u


def _gla_tol(dtype):
    return dict(rtol=5e-2, atol=5e-2) if dtype == "bfloat16" \
        else dict(rtol=2e-4, atol=2e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("B,T,H,K,V", GLA_SHAPES)
@pytest.mark.parametrize("mode", ["ssd", "rwkv"])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_gla_kernel_matches_plain_on_card(B, T, H, K, V, mode, dtype):
    _cuda_or_skip()
    q, k, v, lw, u = _gla_inputs(3, dtype, B, T, H, K, V, mode)
    n = gla_scan.launches
    o, s = gla_scan(q, k, v, lw, u=u, mode=mode)
    torch.cuda.synchronize()
    assert gla_scan.launches == n + 1
    assert o.dtype == v.dtype and s.dtype == torch.float32
    tr = lambda x: x.transpose(1, 2)
    ro, rs = gla_scan_reference(tr(q), tr(k), tr(v), tr(lw), u=u, mode=mode)
    np.testing.assert_allclose(_np(o), _np(tr(ro)), **_gla_tol(dtype))
    np.testing.assert_allclose(_np(s), _np(rs), **_gla_tol(dtype))


# Decays per token: the sweep's strong range, |log w| up to 12, held at the
# sweep's float32 tolerance; and an extreme one, |log w| up to 40, where
# cumulative log decays reach ~1e3 within a chunk. A float32 ulp
# there is 6e-5, so exp of a difference of two of them carries ~1e-4
# relative error in any chunked form (the Pallas kernel's too): 1e-3.
# RWKV6's floor, -exp(10) = -22026 per token: every token there (clamp), and
# the floor or a weak decay per token and channel (mixed), where chunk-wide
# cumulative sums reach ~7e5; held at the extreme tolerance
# (tests/test_torch_gla_design.py::TOL).
DECAYS = {"sweep": (lambda rng, shape: -np.exp(rng.uniform(-6.0, 2.5, shape)), 2e-4),
          "extreme": (lambda rng, shape: -rng.uniform(0.0, 40.0, shape), 1e-3),
          "clamp": (lambda rng, shape: np.full(shape, -np.exp(10.0)), 1e-3),
          "mixed": (lambda rng, shape: np.where(
              rng.uniform(size=shape) < 0.5, -np.exp(10.0),
              -np.exp(rng.uniform(-6.0, 0.0, shape))), 1e-3)}


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["ssd", "rwkv"])
@pytest.mark.parametrize("decay", list(DECAYS))
def test_gla_kernel_strong_decay_stays_finite(mode, decay):
    """On the masked pairs exp(L_read[t] - L[j]) overflows to inf under
    strong decay; the kernel must never take it (0 * inf = NaN)."""
    _cuda_or_skip()
    B, T, H, K, V = 1, 1000, 2, 64, 64
    rng = np.random.default_rng(9)
    q, k, v = _inputs(rng, "float32", (B, T, H, K), (B, T, H, K), (B, T, H, V))
    draw, tol = DECAYS[decay]
    lw = torch.from_numpy(draw(rng, (B, T, H, K)).astype(np.float32)).cuda()
    u = 0.3 * torch.ones(H, K, device="cuda") if mode == "rwkv" else None
    o, s = gla_scan(q, k, v, lw, u=u, mode=mode)
    torch.cuda.synchronize()
    assert torch.isfinite(o).all() and torch.isfinite(s).all()
    tr = lambda x: x.transpose(1, 2)
    ro, rs = gla_scan_reference(tr(q), tr(k), tr(v), tr(lw), u=u, mode=mode)
    np.testing.assert_allclose(_np(o), _np(tr(ro)), rtol=tol, atol=tol)
    np.testing.assert_allclose(_np(s), _np(rs), rtol=tol, atol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("B,T,H,K,V", GLA_SHAPES)
@pytest.mark.parametrize("mode", ["ssd", "rwkv"])
@pytest.mark.parametrize("decay", list(DECAYS))
def test_gla_f32_kernel_holds_the_exact_scan_at_every_decay_on_card(
        B, T, H, K, V, mode, decay):
    """The float32 (3xTF32) kernels against the token-by-token scan at the
    sweep shapes, at every decay including RWKV6's floor (sub-chunk-local
    cumulative sums, the read decay formed before the token's own)."""
    _cuda_or_skip()
    assert gla_route(torch.float32, K, V)[0] == "mma.3xtf32"
    rng = np.random.default_rng(13)
    q, k, v = _inputs(rng, "float32", (B, T, H, K), (B, T, H, K), (B, T, H, V))
    draw, tol = DECAYS[decay]
    lw = torch.from_numpy(draw(rng, (B, T, H, K)).astype(np.float32)).cuda()
    u = _inputs(rng, "float32", (H, K))[0] * 0.3 if mode == "rwkv" else None
    o, s = gla_scan(q, k, v, lw, u=u, mode=mode)
    torch.cuda.synchronize()
    assert torch.isfinite(o).all() and torch.isfinite(s).all()
    tr = lambda x: x.transpose(1, 2)
    ro, rs = gla_scan_reference(tr(q), tr(k), tr(v), tr(lw), u=u, mode=mode)
    np.testing.assert_allclose(_np(o), _np(tr(ro)), rtol=tol, atol=tol)
    np.testing.assert_allclose(_np(s), _np(rs), rtol=tol, atol=tol)


# bf16 path decays per token: the sweep's strong range; the extreme one; and
# RWKV6's floor of -22026 (log w = -exp(10)) beside weak decays, at random
# per token and channel, where cumulative sums that span the floor cancel.
GLA_MMA_DECAYS = {
    "strong": lambda rng, shape: -np.exp(rng.uniform(-6.0, 2.5, shape)),
    "extreme": lambda rng, shape: -rng.uniform(0.0, 40.0, shape),
    "floor": lambda rng, shape: np.where(rng.uniform(size=shape) < 0.5,
                                         -np.exp(10.0),
                                         -np.exp(rng.uniform(-6.0, 0.0, shape))),
}


def _gla_mma_inputs(seed, B, T, H, K, V, mode, lw_dtype, decay):
    rng = np.random.default_rng(seed)
    q, k, v = _inputs(rng, "bfloat16", (B, T, H, K), (B, T, H, K), (B, T, H, V))
    lw = torch.from_numpy(GLA_MMA_DECAYS[decay](rng, (B, T, H, K))
                          .astype(np.float32)).to(DTYPES[lw_dtype]).cuda()
    u = _inputs(rng, "float32", (H, K))[0] * 0.3 if mode == "rwkv" else None
    return q, k, v, lw, u


@pytest.mark.cuda
@pytest.mark.parametrize("T", GLA_MMA_T)
@pytest.mark.parametrize("K,V", GLA_MMA_KV)
@pytest.mark.parametrize("B", [1, 2])
@pytest.mark.parametrize("mode", ["ssd", "rwkv"])
@pytest.mark.parametrize("lw_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("decay", list(GLA_MMA_DECAYS))
def test_gla_mma_kernel_matches_plain_on_card(T, K, V, B, mode, lw_dtype, decay):
    """bf16 q/k/v take the tensor-core path; held at the bf16 tolerance
    (5e-2) against the token-by-token scan of the same inputs, finite."""
    _cuda_or_skip()
    assert gla_route(torch.bfloat16, K, V)[0] == "mma"
    q, k, v, lw, u = _gla_mma_inputs(11, B, T, 2, K, V, mode, lw_dtype, decay)
    n = gla_scan.launches
    o, s = gla_scan(q, k, v, lw, u=u, mode=mode)
    torch.cuda.synchronize()
    assert gla_scan.launches == n + 1
    assert o.dtype == torch.bfloat16 and s.dtype == torch.float32
    assert torch.isfinite(o.float()).all() and torch.isfinite(s).all()
    tr = lambda x: x.transpose(1, 2)
    ro, rs = gla_scan_reference(tr(q), tr(k), tr(v), tr(lw), u=u, mode=mode)
    np.testing.assert_allclose(_np(o), _np(tr(ro)), **_gla_tol("bfloat16"))
    np.testing.assert_allclose(_np(s), _np(rs), **_gla_tol("bfloat16"))


@pytest.mark.cuda
@pytest.mark.parametrize("mode,H", [("rwkv", 32), ("ssd", 64)])
def test_gla_mma_kernel_matches_plain_at_the_served_shape_on_card(mode, H):
    """RWKV6-1.6B's prefill (H = 32) and Zamba2's widths (H = 64) at T = 2048,
    K = V = 64, bf16 q/k/v, float32 log w: bf16 tolerance, and a second call
    on the same inputs is bit-equal (no atomics, a fixed order of sums)."""
    _cuda_or_skip()
    q, k, v, lw, u = _gla_mma_inputs(12, 1, 2048, H, 64, 64, mode, "float32",
                                     "strong")
    o, s = gla_scan(q, k, v, lw, u=u, mode=mode)
    o2, s2 = gla_scan(q, k, v, lw, u=u, mode=mode)
    torch.cuda.synchronize()
    assert torch.equal(o, o2) and torch.equal(s, s2)
    tr = lambda x: x.transpose(1, 2)
    ro, rs = gla_scan_reference(tr(q), tr(k), tr(v), tr(lw), u=u, mode=mode)
    np.testing.assert_allclose(_np(o), _np(tr(ro)), **_gla_tol("bfloat16"))
    np.testing.assert_allclose(_np(s), _np(rs), **_gla_tol("bfloat16"))


@pytest.mark.cuda
@pytest.mark.parametrize("K", [16, 32, 48, 64])
@pytest.mark.parametrize("V", [16, 32, 48, 64])
@pytest.mark.parametrize("mode", ["ssd", "rwkv"])
def test_gla_mma_kernel_every_width_on_card(K, V, mode):
    """Every (K, V) the library instantiates for bf16 runs and holds the bf16
    tolerance: T = 65 (a full chunk and one token), B = 2, both log_w
    dtypes."""
    _cuda_or_skip()
    assert gla_route(torch.bfloat16, K, V)[0] == "mma"
    for lw_dtype in ("float32", "bfloat16"):
        q, k, v, lw, u = _gla_mma_inputs(13, 2, 65, 2, K, V, mode, lw_dtype,
                                         "strong")
        o, s = gla_scan(q, k, v, lw, u=u, mode=mode)
        torch.cuda.synchronize()
        assert torch.isfinite(o.float()).all() and torch.isfinite(s).all()
        tr = lambda x: x.transpose(1, 2)
        ro, rs = gla_scan_reference(tr(q), tr(k), tr(v), tr(lw), u=u, mode=mode)
        np.testing.assert_allclose(_np(o), _np(tr(ro)), **_gla_tol("bfloat16"))
        np.testing.assert_allclose(_np(s), _np(rs), **_gla_tol("bfloat16"))


@pytest.mark.cuda
@pytest.mark.parametrize("K", [16, 32, 48, 64])
@pytest.mark.parametrize("V", [16, 32, 48, 64])
@pytest.mark.parametrize("mode", ["ssd", "rwkv"])
def test_gla_tf32_kernel_every_width_on_card(K, V, mode):
    """Every (K, V) the library instantiates for float32 runs the 3xTF32
    kernels and holds the float32 tolerance (2e-4): T = 1 and 65 (one token;
    a full chunk and one token), B = 2."""
    _cuda_or_skip()
    assert gla_route(torch.float32, K, V)[0] == "mma.3xtf32"
    for T in (1, 65):
        q, k, v, lw, u = _gla_inputs(14, "float32", 2, T, 2, K, V, mode)
        o, s = gla_scan(q, k, v, lw, u=u, mode=mode)
        torch.cuda.synchronize()
        assert torch.isfinite(o).all() and torch.isfinite(s).all()
        tr = lambda x: x.transpose(1, 2)
        ro, rs = gla_scan_reference(tr(q), tr(k), tr(v), tr(lw), u=u, mode=mode)
        np.testing.assert_allclose(_np(o), _np(tr(ro)), **_gla_tol("float32"))
        np.testing.assert_allclose(_np(s), _np(rs), **_gla_tol("float32"))


@pytest.mark.cuda
@pytest.mark.parametrize("mode,H", [("rwkv", 32), ("ssd", 64)])
def test_gla_tf32_kernel_matches_plain_at_the_served_shape_on_card(mode, H):
    """The 3xTF32 kernels at RWKV6-1.6B's prefill shape (H = 32) and
    Zamba2's widths (H = 64), T = 2048, K = V = 64, float32 throughout:
    float32 tolerance, and a second call on the same inputs is bit-equal."""
    _cuda_or_skip()
    q, k, v, lw, u = _gla_inputs(12, "float32", 1, 2048, H, 64, 64, mode)
    o, s = gla_scan(q, k, v, lw, u=u, mode=mode)
    o2, s2 = gla_scan(q, k, v, lw, u=u, mode=mode)
    torch.cuda.synchronize()
    assert torch.equal(o, o2) and torch.equal(s, s2)
    tr = lambda x: x.transpose(1, 2)
    ro, rs = gla_scan_reference(tr(q), tr(k), tr(v), tr(lw), u=u, mode=mode)
    np.testing.assert_allclose(_np(o), _np(tr(ro)), **_gla_tol("float32"))
    np.testing.assert_allclose(_np(s), _np(rs), **_gla_tol("float32"))


@pytest.mark.cuda
def test_gla_scratch_is_the_designs_on_card():
    """The library's chunk tiles and scratch size are those of the design
    that tests/test_torch_gla_design.py and tests/test_torch_gla_f32_design.py
    mirror: 64-token chunks and, per (batch, head, chunk), a (K, V) state
    and K decays, for both dtypes."""
    _cuda_or_skip()
    assert gla_ops.chunk_tokens(torch.bfloat16) == 64
    assert gla_ops.chunk_tokens(torch.float32) == 64
    for B, T, H, K, V in [(2, 130, 3, 32, 48), (1, 2048, 32, 64, 64), (1, 1, 1, 16, 16)]:
        n = B * H * -(-T // 64) * (K * V + K)
        assert gla_ops.scratch_floats(torch.bfloat16, B, T, H, K, V) == n
        assert gla_ops.scratch_floats(torch.float32, B, T, H, K, V) == n
    with pytest.raises(ValueError, match="no gla_scan kernel"):
        gla_ops.scratch_floats(torch.bfloat16, 1, 8, 1, 80, 64)


@pytest.mark.cuda
def test_gla_routes_by_dtype_on_card():
    """bf16 q/k/v run the bf16-pair tensor-core kernels at every K, V the
    wrapper takes, float32 the 3xTF32 ones; the library refuses other
    widths."""
    _cuda_or_skip()
    for K in (16, 32, 48, 64):
        for V in (16, 32, 48, 64):
            assert gla_route(torch.bfloat16, K, V)[0] == "mma"
            assert gla_route(torch.float32, K, V)[0] == "mma.3xtf32"
    assert gla_route(torch.bfloat16, 80, 64)[0] is None


@pytest.mark.cuda
def test_gla_wrapper_refuses_misaligned_views_on_card():
    _cuda_or_skip()
    q = torch.zeros(1, 8, 2, 32, dtype=torch.bfloat16, device="cuda")
    flat = torch.zeros(q.numel() + 1, dtype=torch.bfloat16, device="cuda")
    bad = flat[1:].view(q.shape)
    with pytest.raises(ValueError, match="multiple of 16"):
        gla_scan(bad, q, q, q.float(), mode="ssd")


@pytest.mark.cuda
def test_gla_wrapper_raises_on_what_the_kernel_does_not_take():
    _cuda_or_skip()
    q = torch.zeros(1, 8, 2, 32, device="cuda")
    with pytest.raises(ValueError, match="multiple of 16"):
        gla_scan(q, q, torch.zeros(1, 8, 2, 24, device="cuda"), q, mode="ssd")
    with pytest.raises(ValueError, match="needs u"):
        gla_scan(q, q, q, q, mode="rwkv")
    with pytest.raises(ValueError, match="contiguous"):
        t = torch.zeros(1, 2, 8, 32, device="cuda").transpose(1, 2)
        gla_scan(t, t, t, t, mode="ssd")


@pytest.mark.cuda
def test_rwkv_served_through_the_kernel_on_card():
    """Reduced RWKV6 on the card: every prefill launches gla_scan once per
    layer, and the kernel path agrees with the plain einsum path
    (``gla_chunked``) in float32."""
    _cuda_or_skip()
    from repro_torch.serve.engine import ServeRequest, ServingEngine
    cfg = reduced_config(get_config("rwkv6-1.6b")).replace(dtype="float32")
    params = build_model(cfg).init(0, device="cuda")
    prompt = torch.arange(1, 46, device="cuda")[None]
    outs = {}
    for impl in ("kernel", "einsum"):
        model = build_model(cfg, attn_impl=impl)
        n = gla_scan.launches
        logits, cache = model.prefill(params, {"tokens": prompt}, 64)
        for _ in range(3):
            tok = torch.argmax(logits, -1)[:, None]
            logits, cache = model.decode_step(params, {"tokens": tok}, cache)
        outs[impl] = logits.float().cpu()
        assert gla_scan.launches - n == (cfg.n_layers if impl == "kernel" else 0)
    torch.testing.assert_close(outs["kernel"], outs["einsum"], rtol=1e-4,
                               atol=1e-4)

    model = build_model(cfg)
    engine = ServingEngine(model, params, max_slots=2, max_len=64, device="cuda")
    rng = np.random.default_rng(0)
    for i in range(3):
        engine.submit(ServeRequest(rid=i, prompt=rng.integers(1, 256, 20 + 7 * i),
                                   max_new_tokens=4))
    n = gla_scan.launches
    done = engine.run()
    n_pre = sum(l.kind == "prefill" for l in engine.logs)
    assert len(done) == 3 and n_pre == 3
    assert gla_scan.launches - n == cfg.n_layers * n_pre


# ---------------------------------------------------------------------------
# the simulated path's tensor work on the card, against the CPU
# ---------------------------------------------------------------------------

EQ1_RTOL = 5e-6     # repro_torch.core.power.DEVICE_MODE_RTOL


def _on_card_and_cpu(fn):
    return fn("cuda"), fn("cpu")


@pytest.mark.cuda
def test_simulated_path_eq1_to_eq3_on_card():
    """Eq. 1 power and the Eq. 2-3 report of Table 1a's run: the card's
    float32 pow within 5e-6 of the CPU's, float32 on the card."""
    _cuda_or_skip()
    from repro_torch import core, sim
    res = sim.run_simulation(sim.PAPER_DEFAULT)
    p = core.PowerModel("a100", torch_device="cuda").power(res.stages.mfu)
    assert p.device.type == "cuda" and p.dtype == torch.float32
    want = core.PowerModel("a100", torch_device="cpu").power(res.stages.mfu)
    np.testing.assert_allclose(p.cpu().numpy(), want.numpy(), rtol=EQ1_RTOL)
    card, cpu = _on_card_and_cpu(
        lambda dev: sim.energy_report(res, sim.PAPER_PUE, torch_device=dev))
    for k, v in vars(cpu).items():
        np.testing.assert_allclose(vars(card)[k], v, rtol=EQ1_RTOL, err_msg=k)


@pytest.mark.cuda
@pytest.mark.parametrize("seed", range(3))
def test_microgrid_loop_on_card_matches_cpu(seed):
    """The microgrid scan kernel on the card against the CPU's plain step
    loop: every operation is an IEEE float32 add, multiply, min or max, so
    the traces agree bit for bit."""
    _cuda_or_skip()
    from repro_torch import core
    rng = np.random.default_rng(seed)
    load, solar, ci = (rng.uniform(0, s, 600) for s in (600.0, 800.0, 800.0))
    cfg = core.MicrogridConfig(battery=core.BatteryConfig(
        capacity_wh=100.0, soc_init=0.5, soc_min=0.2, soc_max=0.8))
    card, cpu = _on_card_and_cpu(
        lambda dev: core.simulate(load, solar, ci, cfg, torch_device=dev))
    for k, v in cpu.items():
        assert card[k].device.type == "cuda" and card[k].dtype == torch.float32
        np.testing.assert_array_equal(card[k].cpu().numpy(), v.numpy(), err_msg=k)


@pytest.mark.cuda
def test_table2_cosim_and_fleet_on_card_match_cpu():
    """A co-sim over Table 1a's load and a two-site fleet with a microgrid,
    card against CPU: metrics within 5e-6, assignments bitwise."""
    _cuda_or_skip()
    from repro_torch import core, fleet, sim
    from repro_torch.configs.paper_models import LLAMA3_8B
    from repro_torch.core import datasets
    res = sim.run_simulation(sim.PAPER_DEFAULT)

    def cosim(dev):
        pm = core.PowerModel("a100", torch_device=dev)
        load = core.trace_to_load_signal(res.stages, pm, pue=1.2)
        hours = load.times[-1] / 3600.0 + 1.0
        return core.run_cosim(load, datasets.solar_signal(hours, seed=3),
                              datasets.carbon_intensity_signal(hours, seed=4),
                              torch_device=dev)

    card, cpu = _on_card_and_cpu(cosim)
    for k, v in cpu.metrics.items():
        np.testing.assert_allclose(float(card.metrics[k]), float(v),
                                   rtol=EQ1_RTOL, err_msg=k)
    cfg = fleet.FleetConfig(model=LLAMA3_8B, sites=tuple(
        fleet.SiteConfig(name=t, ci_trace=t,
                         scheduler=sim.SchedulerConfig(batch_cap=16),
                         solar_capacity_w=600.0 * (t == "hydro"),
                         battery_capacity_wh=100.0 * (t == "hydro"))
        for t in ("hydro", "coal")), router="carbon_greedy",
        workload=sim.WorkloadConfig(n_requests=48, qps=5.0, min_len=64,
                                    max_len=512))
    card, cpu = _on_card_and_cpu(
        lambda dev: fleet.run_fleet_simulation(cfg, torch_device=dev))
    np.testing.assert_array_equal(card.assignments, cpu.assignments)
    got = card.summary()
    for k, v in cpu.summary().items():
        np.testing.assert_allclose(got[k], v, rtol=EQ1_RTOL,
                                   atol=EQ1_RTOL * 100 * k.endswith("_pct"),
                                   err_msg=k)


@pytest.mark.cuda
def test_roofline_torch_backend_on_card():
    """The roofline in float64 on the card, over Table 1a's stages: within
    1e-5 of the numpy path (``TORCH_BACKEND_RTOL``)."""
    _cuda_or_skip()
    import dataclasses

    from repro_torch import sim
    from repro_torch.sim.execmodel import (TORCH_BACKEND_RTOL, StageBatch,
                                           cached_execution_model)
    cfg = sim.PAPER_DEFAULT
    res = sim.run_simulation(cfg)
    em = cached_execution_model(cfg.model, cfg.device, 1, 1, cfg.execmodel)
    batch = StageBatch.from_trace(res.stages)
    want = em.stage_cost_batch(batch)
    got = em.stage_cost_batch(batch, backend="torch", torch_device="cuda")
    for f in dataclasses.fields(want):
        np.testing.assert_allclose(getattr(got, f.name), getattr(want, f.name),
                                   rtol=TORCH_BACKEND_RTOL, err_msg=f.name)


# ---------------------------------------------------------------------------
# microgrid_scan: the kernel against its plain step loop on the card
# ---------------------------------------------------------------------------

def _equal_nan(a, b):
    nan_a, nan_b = torch.isnan(a), torch.isnan(b)
    return bool(torch.equal(nan_a, nan_b)) and bool(torch.equal(
        torch.where(nan_a, 0.0, a), torch.where(nan_b, 0.0, b)))


def _microgrids():
    from repro_torch import core
    battery = lambda **kw: core.MicrogridConfig(battery=core.BatteryConfig(**kw))
    return {"default": core.MicrogridConfig(),
            "table1b": battery(capacity_wh=100.0, soc_init=0.5, soc_min=0.2,
                               soc_max=0.8),
            "slow-5min": core.MicrogridConfig(
                step_s=300.0, battery=core.BatteryConfig(
                    capacity_wh=500.0, soc_init=0.2, max_charge_w=150.0,
                    max_discharge_w=90.0, efficiency=0.9)),
            "no-battery": battery(capacity_wh=0.0),
            "zero-rates": battery(max_charge_w=0.0, max_discharge_w=0.0)}


def _random_grid_inputs(T, seed, B=1):
    rng = np.random.default_rng(seed)
    return [torch.as_tensor(rng.uniform(lo, hi, (B, T)), dtype=torch.float32,
                            device="cuda")
            for lo, hi in ((0, 600.0), (0, 800.0), (50, 800.0))]


def _signed_zero_grid_inputs(T, seed):
    """Random traces with signed zeros and a NaN in the surplus (as
    chip_smoke.signed_zero_inputs): surplus -0 every 7th step, +0 from -0
    load every 11th, both +0 every 13th, a NaN load 100 steps before the
    end. The kernel's chain folds max_chg and max_dis_w into caps computed
    off the chain (min is associative): the same values here too."""
    load, solar, ci = _random_grid_inputs(T, seed)
    for every, ld, sol in ((7, 0.0, -0.0), (11, -0.0, 0.0), (13, 0.0, 0.0)):
        load[:, ::every], solar[:, ::every] = ld, sol
    load[:, T - 100] = float("nan")
    return load, solar, ci


def _table2_inputs():
    """Table 2's co-sim inputs as ``core.run_cosim`` hands them to the scan
    (from a CPU run of ``run_simulation(PAPER_DEFAULT)``)."""
    from repro_torch import core, sim
    from repro_torch.core import datasets
    res = sim.run_simulation(sim.PAPER_DEFAULT)
    pm = core.PowerModel(res.cfg.device, torch_device="cpu")
    load = core.stages_to_load_signal(res.stages.start_s, res.stages.dur_s,
                                      res.stages.mfu, pm, pue=1.2)
    n_bins, start = 1800, 480
    vals = np.full(n_bins, pm.dev.p_idle * 1.2)
    n = min(len(load.values), n_bins - start)
    vals[start:start + n] = load.values[:n]
    t = np.arange(n_bins) * 60.0
    solar = datasets.solar_signal(30.0, capacity_w=600.0, seed=3,
                                  cloudiness=0.12).at(t)
    ci = datasets.carbon_intensity_signal(30.0, seed=4).at(t)
    return [torch.as_tensor(np.asarray(x, np.float32)[None], device="cuda")
            for x in (vals, solar, ci)]


# (label, inputs(window), microgrid): phase 3's cases of chip_smoke.py
MICROGRID_CASES = (
    [("table2", lambda w: _table2_inputs(), "table1b")]
    + [(f"random-s{seed}-{grid}", lambda w, s=seed: _random_grid_inputs(1800, s),
        grid) for seed in range(2)
       for grid in ("default", "table1b", "slow-5min", "no-battery")]
    + [("batch-of-3", lambda w: _random_grid_inputs(w + 5, 7, B=3), "default"),
       ("T0", lambda w: _random_grid_inputs(0, 0), "table1b"),
       ("three-windows", lambda w: _random_grid_inputs(2 * w + 123, 9),
        "default"),
       ("three-windows-no-battery",
        lambda w: _random_grid_inputs(2 * w + 123, 10), "no-battery"),
       ("one-step-tail", lambda w: _random_grid_inputs(w + 1, 12), "default"),
       ("signed-zeros-nan", lambda w: _signed_zero_grid_inputs(1800, 13),
        "table1b"),
       ("signed-zeros-nan-zero-rates",
        lambda w: _signed_zero_grid_inputs(1800, 13), "zero-rates"),
       # a year at 60 s: windows after windows
       ("year", lambda w: _random_grid_inputs(525600, 11), "table1b")])


@pytest.mark.cuda
@pytest.mark.parametrize("label,inputs,grid", MICROGRID_CASES,
                         ids=[c[0] for c in MICROGRID_CASES])
def test_microgrid_scan_kernel_matches_plain_loop_on_card(label, inputs, grid):
    """One launch walks every trace; its traces equal the plain step loop's
    on the card bit for bit, NaN (no battery, a NaN input) in the same
    places."""
    _cuda_or_skip()
    from repro_torch.core.microgrid import constants
    from repro_torch.kernels.microgrid_scan import (microgrid_scan,
                                                    microgrid_scan_reference)
    from repro_torch.kernels.microgrid_scan.ops import window_steps
    x = inputs(window_steps())
    k = constants(_microgrids()[grid])
    n = microgrid_scan.launches
    out = microgrid_scan(*x, k)
    torch.cuda.synchronize()
    assert microgrid_scan.launches - n == (1 if out.numel() else 0)
    ref = microgrid_scan_reference(*x, k)
    assert out.shape == ref.shape == (7,) + tuple(x[0].shape)
    assert _equal_nan(out, ref)
    assert bool(torch.isnan(out[0]).any()) == (
        (grid == "no-battery" or label.startswith("signed")) and out.numel() > 0)


@pytest.mark.cuda
def test_smoke_sweep_device_mode_on_card_matches_cpu():
    """fig4's smoke sweep in device mode: the card's records against the
    CPU's under ``obs.diff``. Columns the host computes are bitwise; Eq. 1
    and the device program's float64 sums within ``DEVICE_MODE_RTOL``."""
    _cuda_or_skip()
    from repro_torch.obs.diff import diff_records
    from repro_torch.sweep.scenarios import run_sweep
    card, cpu = _on_card_and_cpu(
        lambda dev: run_sweep("fig4", smoke=True, mode="device",
                              torch_device=dev)[0])
    result = diff_records(cpu, card)
    assert not result.only_a and not result.only_b and len(card) == 3
    for c in result.cells:
        assert c.contract in ("host-bitwise", "DEVICE_MODE_RTOL"), c.format()
        assert c.phase in ("power", "energy", "carbon") \
            or c.column in ("duration_s", "gpu_hours"), c.format()


@pytest.mark.cuda
def test_remote_card_worker_matches_in_process_card_run(tmp_path):
    """One worker spawned on the card computes a 2x2 grid (two trace groups
    of two PUE points) in vectorized and in device mode: its records equal
    the in-process card run's bit for bit, and one group re-run in process
    (``verify_groups``) agrees."""
    _cuda_or_skip()
    from repro_torch.configs.paper_models import LLAMA3_8B
    from repro_torch.sim import SchedulerConfig, SimConfig, WorkloadConfig
    from repro_torch.sweep import GridSpec, ResultCache, SweepRunner
    from repro_torch.sweep.remote import RemoteOptions
    base = SimConfig(model=LLAMA3_8B,
                     workload=WorkloadConfig(n_requests=10, qps=4.0,
                                             min_len=64, max_len=256, seed=0),
                     scheduler=SchedulerConfig(batch_cap=8))
    scenarios = GridSpec(base=base, axes={"workload.qps": [2.0, 3.0],
                                          "pue": [1.0, 1.1]}).expand()
    for mode in ("vectorized", "device"):
        opts = RemoteOptions(queue_dir=tmp_path / f"q-{mode}",
                             spawn_workers=1, lease_s=60.0, verify_groups=1,
                             timeout_s=300)
        records, stats = SweepRunner(
            cache=ResultCache(tmp_path / f"cache-{mode}", torch_device="cuda"),
            backend="remote", remote=opts, mode=mode,
            torch_device="cuda").run(scenarios)
        local, _ = SweepRunner(mode=mode, torch_device="cuda").run(scenarios)
        assert stats.executed == 4 and stats.remote_workers == 1
        assert stats.lease_expired == stats.quarantined == 0
        assert [r["metrics"] for r in records] == \
            [r["metrics"] for r in local], mode
        assert (tmp_path / f"cache-{mode}" / "cuda").is_dir()
        assert not (tmp_path / f"cache-{mode}" / "cpu").exists()
