"""The port's CUDA kernels on the card, against their plain versions.

Every test here is marked ``cuda`` and skips inside the test when no card is
present. The file imports neither ``jax`` nor ``repro``, so it runs on a
machine with the card and PyTorch only:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_card.py

The shape sweeps are those of ``tests/test_kernels.py``; tolerances are the
same (float32 2e-5, bfloat16 2e-2).
"""
import numpy as np
import pytest
import torch

from repro_torch.configs import get_config, reduced_config
from repro_torch.kernels.decode_attention import (decode_attention,
                                                  decode_attention_reference)
from repro_torch.kernels.flash_attention import (attention_reference,
                                                 flash_attention)
from repro_torch.models import build_model

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
FLASH_SHAPES = [(1, 128, 4, 4, 64), (2, 256, 4, 2, 64),
                (1, 200, 8, 1, 32),   # unpadded seq, MQA
                (2, 64, 6, 3, 80)]    # odd heads / head_dim
FLASH_MASKS = [(True, None), (True, 64), (False, None)]
DECODE_SHAPES = [(2, 512, 8, 2, 64), (1, 1024, 4, 4, 128), (3, 300, 6, 3, 80)]


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


@pytest.mark.cuda
@pytest.mark.parametrize("B,S,H,KV,D", FLASH_SHAPES)
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("causal,window", FLASH_MASKS)
def test_flash_kernel_matches_plain_on_card(B, S, H, KV, D, dtype, causal,
                                            window):
    _cuda_or_skip()
    q, k, v = _inputs(np.random.default_rng(0), dtype, (B, S, H, D),
                      (B, S, KV, D), (B, S, KV, D))
    n = flash_attention.launches
    out = flash_attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert flash_attention.launches == n + 1
    tr = lambda x: x.transpose(1, 2)
    ref = tr(attention_reference(tr(q), tr(k), tr(v), causal=causal,
                                 window=window))
    np.testing.assert_allclose(_np(out), _np(ref), **_tol(dtype))


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
