"""The FLOP and byte counters against hand counts at small shapes."""
import pytest

from _small import ROOT  # noqa: F401  (paths)
from bench import roofline
from bench.reference import moe_transformer as ref


def brute_pairs(S, causal, window):
    return sum(1 for q in range(S) for k in range(S)
               if (not causal or k <= q) and (window is None or k > q - window))


@pytest.mark.parametrize("S,causal,window", [
    (1, True, None), (7, True, None), (7, True, 3), (7, True, 7), (7, True, 9),
    (6, False, None), (10, True, 4)])
def test_visible_pairs(S, causal, window):
    assert roofline.visible_pairs(S, causal, window) == brute_pairs(S, causal, window)


def test_flash_bound_terms():
    S, H, KV, D = 1000, 4, 2, 128
    pairs = S * (S + 1) // 2
    ops = 4 * D * H * pairs / 989e12
    nbytes = S * (2 * H + 2 * KV) * D * 2 / 3.35e12
    assert roofline.flash_fwd_s(S, H, KV, D) == pytest.approx(
        max(ops, nbytes, roofline.exp2_s(H * pairs)))
    # a single query is bound by its bytes
    assert roofline.flash_fwd_s(1, H, KV, D) == pytest.approx(
        (2 * H + 2 * KV) * D * 2 / 3.35e12)


def test_decode_bound_bytes():
    valid, H, KV, D = [5, 1, 300], 8, 2, 64
    nbytes = 2 * (5 + 1 + 300) * KV * D * 2 + 2 * 3 * H * D * 2
    assert roofline.decode_attn_s(valid, H, KV, D) == pytest.approx(nbytes / 3.35e12)


def test_exp2_time_between_its_units():
    # the faster of the two routes' mix: no slower than the special-function
    # units alone, no faster than the FMA pipes' share of the work
    n = 1e9
    sfu = n / (roofline.SFU_PER_CLOCK * roofline.SM_CLOCKS_PER_S)
    fma = n * roofline.SOFTMAX_FMAS / (roofline.FMA_PER_CLOCK * roofline.SM_CLOCKS_PER_S)
    assert fma < roofline.exp2_s(n) < sfu


CFG = {"num_hidden_layers": 3, "hidden_size": 16, "num_attention_heads": 4,
       "num_key_value_heads": 2, "head_dim": 8, "num_local_experts": 4,
       "num_experts_per_tok": 2, "intermediate_size": 12, "vocab_size": 50,
       "rms_norm_eps": 1e-5, "rope_theta": 1e6, "capacity_factor": 1.25}


def hand_token_flops():
    attn = 16 * 4 * 8 + 2 * 16 * 2 * 8 + 4 * 8 * 16
    return 2 * (attn + 16 * 4 + 2 * 3 * 16 * 12)


@pytest.mark.parametrize("window", [None, 5])
def test_prefill_flops(window):
    cfg = dict(CFG, sliding_window=window)
    P = 9
    pairs = brute_pairs(P, True, window)
    want = 3 * (P * hand_token_flops() + 4 * 8 * 4 * pairs) + 2 * 16 * 50
    assert ref.prefill_flops(cfg, P) == want


@pytest.mark.parametrize("window", [None, 5])
def test_decode_flops(window):
    cfg = dict(CFG, sliding_window=window)
    keys = [3, 9, 1]
    seen = sum(k if window is None else min(k, window) for k in keys)
    want = 3 * (3 * hand_token_flops() + 4 * 8 * 4 * seen) + 3 * 2 * 16 * 50
    assert ref.decode_flops(cfg, keys) == want
