"""The arithmetic of the float32 ``gla_scan`` kernels' design, on the CPU.

The float32 route of ``src/repro_torch/kernels/gla_scan/csrc/gla_scan.cu``
(``mma.3xtf32``) runs the bf16 route's decomposition (``tests/_gla_design.py``:
64-token chunks of four 16-token sub-chunks, log2 units, per-token log2
decays clamped at -64, no chunk-wide cumulative sum subtracted from
another) with float32 operands on TF32 tensor cores. TF32 keeps 10
explicit mantissa bits, and float32 inputs are not exact in it, so every
operand of every product, q, k and v included, is split as the kernel
splits it: hi = ``cvt.rna.tf32(x)``, lo = ``cvt.rna.tf32(x - hi)``, three
products with lo @ lo dropped (``design_scan(..., tf32=True)``). Here that
mirror is held against the token-by-token scan (``gla_reference``) at the
float32 tolerances, 2e-4 at the sweep's decays and 1e-3 at extreme decays
and RWKV6's floor, and against the JAX package's Pallas kernel in
interpret mode where ``tests/test_torch_gla_design.py`` holds the plain
float32 mirror to it; and one TF32 rounding per operand, in place of the
pair, is shown to miss 2e-4 at the served length. What the mirror cannot
show is the tensor cores' own accumulation, which the kernel bounds by
short chains (its header, "float32 q, k, v") and ``chip_smoke.py`` and
``tests/test_torch_card.py`` check on the card.
"""
import pytest
import torch

from _gla_design import SHAPES, TOL, _inputs, design_scan, hold_to_reference_and_pallas, tf32_rna
from repro_torch.models.linear_attention import gla_reference


def test_tf32_rna_rounds_as_cvt_rna():
    """Round to nearest on 10 explicit mantissa bits, ties away from zero
    whatever the sign, the low 13 bits cleared; TF32 values are fixed."""
    ulp = 2.0 ** -10
    x = torch.tensor([1.0 + ulp / 2, 1.0 + 3 * ulp / 2, -(1.0 + ulp / 2),
                      1.0 + ulp / 2 - 2.0 ** -20, 1.0 + ulp, -3.0, 0.0])
    want = [1.0 + ulp, 1.0 + 2 * ulp, -(1.0 + ulp), 1.0, 1.0 + ulp, -3.0, 0.0]
    assert tf32_rna(x).tolist() == want
    r = tf32_rna(torch.randn(1000, generator=torch.Generator().manual_seed(0)))
    assert not (r.view(torch.int32) & 0x1FFF).any()
    assert torch.equal(tf32_rna(r), r)


@pytest.mark.parametrize("B,T,H,K,V", SHAPES)
@pytest.mark.parametrize("mode", ["ssd", "rwkv"])
@pytest.mark.parametrize("decay", list(TOL))
def test_tf32_design_matches_reference_and_pallas(B, T, H, K, V, mode, decay):
    hold_to_reference_and_pallas(5, B, T, H, K, V, mode, decay, tf32=True)


@pytest.mark.parametrize("mode", ["ssd", "rwkv"])
def test_tf32_design_holds_the_float32_tolerance_at_the_served_length(mode):
    """T = 2048 (RWKV6's served prefill), one head of K = V = 64, the
    sweep's decays: 2e-4 against the exact scan, outputs and final state."""
    hold_to_reference_and_pallas(7, 1, 2048, 1, 64, 64, mode, "sweep", tf32=True)


@pytest.mark.parametrize("mode", ["ssd", "rwkv"])
def test_tf32_single_roundings_miss_the_float32_tolerance(mode):
    """Why the kernel takes each float32 operand as a TF32 pair: the same
    products with one TF32 rounding per operand leave the 2e-4 tolerance at
    the served length by two orders of magnitude, where the pairs keep it."""
    q, k, v, lw, u = _inputs(7, 1, 2048, 1, 64, 64, mode, "sweep")
    ro, _ = gla_reference(q, k, v, lw, u=u, mode=mode)
    excess = {}
    for split in (True, False):
        o, _, _ = design_scan(q, k, v, lw, u=u, mode=mode, tf32=True, split=split)
        excess[split] = float(((o - ro).abs() - TOL["sweep"] * ro.abs()).max())
    assert excess[True] <= TOL["sweep"] < excess[False] / 10
