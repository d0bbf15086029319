"""The arithmetic of the bf16 ``gla_scan`` kernels' design, on the CPU.

The bf16 route of ``src/repro_torch/kernels/gla_scan/csrc/gla_scan.cu`` runs
only on the card. ``tests/_gla_design.py`` holds a plain-torch mirror of its
decomposition (``design_scan``: chunks of 64 tokens, sub-chunks of 16, log2
units, per-token log2 decays clamped at -64, local cumulative decays that
never subtract one chunk-wide sum from another); this file checks it
against the token-by-token scan (``gla_reference``) and the JAX package's
Pallas kernel in interpret mode, as ``tests/test_kernels.py`` runs it.

The clamp bounds the local cumulative decays of a sub-chunk by 16 * 64, so
their differences in the diagonal sub-block keep ~1e-4 relative accuracy
even where RWKV6's floor of -22026 per token sits beside weak decays.
Every exponent the mirror forms must be <= 0, whatever the decay. With
``bf16=True`` the mirror takes its products as the bf16 route's tensor
cores do, each float32 operand split into a bf16 pair (hi + lo, three
products), and rounds the output to bf16, so the bf16 case shows that
those roundings hold the bf16 tolerance (one bf16 rounding of an operand,
in place of the pair, did not at T = 2048 with weak decays). The float32
route's TF32 pairs are held in ``tests/test_torch_gla_f32_design.py``.

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
leaves the tolerance there. The plain chunked scan ``gla_chunked`` is held
against the exact scan at every decay too; it subtracts no chunk-wide
cumulative sums either.
"""
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from _gla_design import (C, LW2_FLOOR, SHAPES, SUB, TOL, _inputs, design_scan,
                         hold_to_reference_and_pallas)
from repro_torch.kernels.gla_scan import ops as gla_ops
from repro_torch.models.linear_attention import gla_chunked, gla_reference


@pytest.mark.parametrize("B,T,H,K,V", SHAPES)
@pytest.mark.parametrize("mode", ["ssd", "rwkv"])
@pytest.mark.parametrize("decay", list(TOL))
def test_design_matches_reference_and_pallas(B, T, H, K, V, mode, decay):
    hold_to_reference_and_pallas(5, B, T, H, K, V, mode, decay)


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
    """``gla_chunked`` (RWKV6's einsum prefill, and training's scan) holds
    the exact scan at every decay, RWKV6's floor included, outputs and final
    state. The reference's ``gla_chunked`` misses it at ``clamp`` (rwkv:
    max |do| 3.55 at T = 130) and ``mixed``; the port's agrees with the
    reference's at ``sweep`` decays (``tests/test_torch_rwkv.py``)."""
    q, k, v, lw, u = _inputs(5, B, T, H, K, V, mode, decay)
    tol = dict(rtol=TOL[decay], atol=TOL[decay])
    ro, rs = gla_reference(q, k, v, lw, u=u, mode=mode)
    o, s = gla_chunked(q, k, v, lw, u=u, mode=mode)
    assert torch.isfinite(o).all() and torch.isfinite(s).all()
    np.testing.assert_allclose(o.numpy(), ro.numpy(), **tol)
    np.testing.assert_allclose(s.numpy(), rs.numpy(), **tol)


def test_f32_mirror_tiles_are_the_kernels():
    """The float32 route runs the mirror's chunk, sub-chunk and clamp: the
    source's MC, SUB and LW2_FLOOR are the mirror's C, SUB and LW2_FLOOR,
    and both float32 kernels tile by MC and SUB (the chunk the library
    reports for float32 is held on the card, ``tests/test_torch_card.py``)."""
    src = (Path(gla_ops.__file__).parent / "csrc" / "gla_scan.cu").read_text()
    tile = lambda name: int(re.search(rf"constexpr int {name} = (\d+);", src)[1])
    assert (tile("MC"), tile("SUB")) == (C, SUB)
    assert -LW2_FLOOR == float(re.search(r"LW2_FLOOR = (-[\d.]+)f;", src)[1])
    for kernel in ("gla_scan_chunk_state_tf32_kernel",
                   "gla_scan_chunk_output_tf32_kernel"):
        body = src[src.index(f"{kernel}("):]
        body = body[:body.index("\n}\n")]
        assert re.search(r"\bMC\b", body) and re.search(r"\bSUB\b", body)
