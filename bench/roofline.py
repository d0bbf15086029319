"""The card's peaks and the kernels' least times (their rooflines).

The peaks are NVIDIA's data sheet for the H100 SXM, dense rates, at the
full 700 W power limit (copied from src/repro_torch/core/power.py::H100_SXM
and chip_smoke.py). Each bound counts each input byte read once and each
output byte written once, and the operations the mask lets through.
"""
from __future__ import annotations

from typing import Optional, Sequence

# copied from src/repro_torch/core/power.py::H100_SXM
PEAK_BF16_FLOPS = 989e12     # dense bf16 tensor-core rate
HBM_BYTES_PER_S = 3.35e12    # HBM3

# copied from chip_smoke.py: per SM and clock (the CUDA programming guide's
# throughput table, compute capability 9.0) exp2 on the special-function
# units 16, float32 add, multiply and FMA 128; 132 SMs at the 1.83 GHz that
# gives the bf16 peak. An exp2 may run on the FMA pipes instead as a cubic
# (6 FMA-pipe instructions), and each visible pair takes at least 2
# FMA-pipe instructions beside its exp2 (the scaling FMA, the row sum's add).
SM_CLOCKS_PER_S = 132 * 1.83e9
SFU_PER_CLOCK, FMA_PER_CLOCK = 16, 128
POLY_EXP2_FMAS, SOFTMAX_FMAS = 6, 2


# copied from chip_smoke.py::exp2_ms, in seconds
def exp2_s(exp2s: float) -> float:
    """Least seconds for ``exp2s`` exp2, each with SOFTMAX_FMAS other
    FMA-pipe instructions: a share of the exp2 runs as the cubic on the FMA
    pipes and the rest on the special-function units, the share chosen so
    that both finish together."""
    f = max(0.0, (FMA_PER_CLOCK / SFU_PER_CLOCK - SOFTMAX_FMAS)
            / (FMA_PER_CLOCK / SFU_PER_CLOCK + POLY_EXP2_FMAS))
    clocks = max((1 - f) / SFU_PER_CLOCK,
                 (SOFTMAX_FMAS + f * POLY_EXP2_FMAS) / FMA_PER_CLOCK)
    return exp2s * clocks / SM_CLOCKS_PER_S


# chip_smoke.py::visible_pairs, in closed form
def visible_pairs(S: int, causal: bool, window: Optional[int]) -> int:
    """(query, key) pairs the mask lets through in one (batch, head)."""
    if not causal:
        return S * (S if window is None else min(S, window))
    if window is None or window >= S:
        return S * (S + 1) // 2
    return window * (window + 1) // 2 + (S - window) * window


def flash_fwd_s(S: int, H: int, KV: int, D: int, causal: bool = True,
                window: Optional[int] = None, elem: int = 2) -> float:
    """Least seconds of one bf16 flash forward of one sequence (B = 1), as
    chip_smoke.py::flash_bound: the larger of the tensor cores' operations
    (4 D H a visible pair), one exp2 a visible pair and the bytes (q, k, v
    read, the output written)."""
    pairs = visible_pairs(S, causal, window)
    nbytes = S * (2 * H + 2 * KV) * D * elem
    return max(4 * D * H * pairs / PEAK_BF16_FLOPS, exp2_s(H * pairs),
               nbytes / HBM_BYTES_PER_S)


def decode_attn_s(valid: Sequence[int], H: int, KV: int, D: int,
                  elem: int = 2) -> float:
    """Least seconds of one decode-attention call: K and V up to each row's
    ``valid`` slots read, q read and the output written, at the card's
    bandwidth (decode attention is bound by its bytes)."""
    nbytes = (2 * sum(valid) * KV + 2 * len(valid) * H) * D * elem
    return nbytes / HBM_BYTES_PER_S
