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
from repro_torch.kernels.flash_attention import (attention_reference,
                                                 flash_attention)
from repro_torch.kernels.gla_scan import gla_scan, gla_scan_reference
from repro_torch.kernels.gla_scan import ops as gla_ops
from repro_torch.kernels.gla_scan.ops import kernel_route as gla_route
from repro_torch.models import build_model

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
FLASH_SHAPES = [(1, 128, 4, 4, 64), (2, 256, 4, 2, 64),
                (1, 200, 8, 1, 32),   # unpadded seq, MQA
                (2, 64, 6, 3, 80)]    # odd heads / head_dim
FLASH_MASKS = [(True, None), (True, 64), (False, None)]
# The wgmma path (bf16 at head_dim 64 and 128): S on both sides of the 64-row
# consumer and 128-row tiles, batch 1 and 2, GQA groups 1, 4 and 8 of H = 8,
# causal, windows 64 and 1000, non-causal; q scaled x8 as well, so that
# scores (standard deviation 8) reach about +-60 and exercise the exp2
# rescaling.
WGMMA_S = [1, 63, 64, 127, 128, 129, 1000, 2048]
WGMMA_MASKS = [(True, None), (True, 64), (True, 1000), (False, None)]
# (B, S, H, KV, D, dtype, causal, window, amp): amp scales q
FLASH_CASES = (
    [(B, S, H, KV, D, dtype, causal, window, 1)
     for B, S, H, KV, D in FLASH_SHAPES for dtype in DTYPES
     for causal, window in FLASH_MASKS]
    + [(B, S, 8, 8 // group, D, "bfloat16", causal, window, amp)
       for D in (64, 128) for S in WGMMA_S for B in (1, 2)
       for group in (1, 4, 8) for causal, window in WGMMA_MASKS
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
    q, k, v = _flash_inputs(0, B, S, H, KV, D, dtype, amp)
    n = flash_attention.launches
    out = flash_attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert flash_attention.launches == n + 1
    tr = lambda x: x.transpose(1, 2)
    ref = tr(attention_reference(tr(q), tr(k), tr(v), causal=causal,
                                 window=window))
    np.testing.assert_allclose(_np(out), _np(ref), **_tol(dtype))


@pytest.mark.cuda
@pytest.mark.parametrize("D", [64, 128])
def test_flash_kernel_is_deterministic_on_card(D):
    """Two launches on the same input give the same bits."""
    _cuda_or_skip()
    q, k, v = _flash_inputs(4, 2, 1000, 8, 2, D, "bfloat16", 8)
    a = flash_attention(q, k, v, causal=True, window=None)
    b = flash_attention(q, k, v, causal=True, window=None)
    torch.cuda.synchronize()
    assert torch.equal(a, b)


@pytest.mark.cuda
def test_flash_wrapper_refuses_misaligned_views_on_card():
    """A view 2 bytes into its storage is contiguous but not 16-byte
    aligned, which TMA cannot take: the wrapper raises before any launch."""
    _cuda_or_skip()
    B, S, H, D = 1, 64, 2, 128
    n = B * S * H * D
    q = torch.zeros(n + 8, dtype=torch.bfloat16, device="cuda")[1:n + 1]
    q = q.view(B, S, H, D)
    k = torch.zeros(B, S, H, D, dtype=torch.bfloat16, device="cuda")
    launches = flash_attention.launches
    with pytest.raises(ValueError, match="16 bytes"):
        flash_attention(q, k, k)
    assert flash_attention.launches == launches


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
# cumulative log decays reach ~1e3 within a 32-token chunk. A float32 ulp
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
    """The float32 kernel against the token-by-token scan at the sweep
    shapes, at every decay including RWKV6's floor (sub-chunk-local
    cumulative sums, the read decay formed before the token's own)."""
    _cuda_or_skip()
    assert gla_route(torch.float32, K, V)[0] == "fma"
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
def test_gla_scratch_is_the_designs_on_card():
    """The library's chunk tiles and scratch size are those of the design
    that tests/test_torch_gla_design.py mirrors: 64-token chunks and, per
    (batch, head, chunk), a (K, V) state and K decays for bf16; the float32
    kernel's 32-token chunks and no scratch."""
    _cuda_or_skip()
    assert gla_ops.chunk_tokens(torch.bfloat16) == 64
    assert gla_ops.chunk_tokens(torch.float32) == 32
    for B, T, H, K, V in [(2, 130, 3, 32, 48), (1, 2048, 32, 64, 64), (1, 1, 1, 16, 16)]:
        n = B * H * -(-T // 64) * (K * V + K)
        assert gla_ops.scratch_floats(torch.bfloat16, B, T, H, K, V) == n
        assert gla_ops.scratch_floats(torch.float32, B, T, H, K, V) == 0
    with pytest.raises(ValueError, match="no gla_scan kernel"):
        gla_ops.scratch_floats(torch.bfloat16, 1, 8, 1, 80, 64)


@pytest.mark.cuda
def test_gla_routes_by_dtype_on_card():
    """bf16 q/k/v run the tensor-core kernels at every K, V the wrapper takes;
    float32 keeps the FMA kernel; the library refuses other widths."""
    _cuda_or_skip()
    for K in (16, 32, 48, 64):
        for V in (16, 32, 48, 64):
            assert gla_route(torch.bfloat16, K, V)[0] == "mma"
            assert gla_route(torch.float32, K, V)[0] == "fma"
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
            "no-battery": battery(capacity_wh=0.0)}


def _random_grid_inputs(T, seed, B=1):
    rng = np.random.default_rng(seed)
    return [torch.as_tensor(rng.uniform(lo, hi, (B, T)), dtype=torch.float32,
                            device="cuda")
            for lo, hi in ((0, 600.0), (0, 800.0), (50, 800.0))]


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
        lambda w: _random_grid_inputs(2 * w + 123, 10), "no-battery")])


@pytest.mark.cuda
@pytest.mark.parametrize("label,inputs,grid", MICROGRID_CASES,
                         ids=[c[0] for c in MICROGRID_CASES])
def test_microgrid_scan_kernel_matches_plain_loop_on_card(label, inputs, grid):
    """One launch walks every trace; its traces equal the plain step loop's
    on the card bit for bit, NaN (no battery) in the same places."""
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
    assert bool(torch.isnan(out[0]).any()) == (grid == "no-battery"
                                               and out.numel() > 0)


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
