"""The metric arithmetic on synthetic iterations and clocks, against hand
counts."""
import math
from types import SimpleNamespace

import pytest

from _small import ROOT  # noqa: F401  (paths)
from bench import run
from bench.readers import reader
from bench.loop import Iteration, Served
from bench.reference import moe_transformer as ref

CFG = {"num_hidden_layers": 2, "hidden_size": 8, "num_attention_heads": 2,
       "num_key_value_heads": 1, "head_dim": 4, "num_experts": 4,
       "num_experts_per_tok": 2, "moe_intermediate_size": 6, "vocab_size": 10,
       "rms_norm_eps": 1e-6, "rope_theta": 1e4, "capacity_factor": 1.25}


def record():
    """A window from t=10 to t=12: a prefill of 100 tokens (0.5 s), two
    decode steps over 3 rows (0.25 s each), a prefill of 50 (0.25 s); one
    iteration before the window and one after it."""
    loop = SimpleNamespace(iterations=[
        Iteration(9.0, 9.9, "prefill", 41, prompt=40),
        Iteration(10.0, 10.5, "prefill", 101, prompt=100),
        Iteration(10.5, 10.75, "decode", 3, keys=[101, 11, 21]),
        Iteration(10.75, 11.0, "decode", 3, keys=[102, 12, 22]),
        Iteration(11.0, 11.25, "prefill", 51, prompt=50),
        Iteration(12.0, 12.5, "decode", 3, keys=[103, 13, 23]),
    ], served={
        0: Served(None, 3, 9.5, t_first=10.5, t_done=11.0, tokens=[1, 2, 3]),
        1: Served(None, 1, 10.9, t_first=11.25, t_done=11.25, tokens=[4]),
        2: Served(None, 2, 8.0, t_first=9.9, t_done=10.75, tokens=[5, 6]),
        3: Served(None, 9, 8.5, t_first=9.0, t_done=math.nan, tokens=[]),
    })
    return run.Record(CFG, ref, loop, 10.0, 12.0, 300.0, 42.0, None)


def value(name, rec):
    return reader(name)(rec)


def test_window_selection():
    rec = record()
    assert rec.seconds == 2.0 and len(rec.iterations) == 4
    assert rec.tokens == 101 + 3 + 3 + 51
    assert sorted(len(s.tokens) for s in rec.done_in_window) == [1, 2, 3]


def test_end_to_end_readers():
    rec = record()
    assert value("tok_s", rec) == pytest.approx(158 / 2.0)
    # first tokens in the window: requests 0 (1.0 s) and 1 (0.35 s); p90
    # between them, linear: 0.35 + 0.9 * 0.65
    assert value("ttft_p90_ms", rec) == pytest.approx((0.35 + 0.9 * 0.65) * 1e3)
    # finished with >= 2 tokens: request 0 (0.5 s / 2) and 2 (0.85 s / 1)
    assert value("tpot_p90_ms", rec) == pytest.approx((0.25 + 0.9 * 0.6) * 1e3)
    assert value("j_per_tok", rec) == pytest.approx(300.0 / 158)
    assert value("setup_s", rec) == 42.0
    assert value("power_w", rec) == pytest.approx(150.0)


def test_engine_readers():
    rec = record()
    assert value("prefill_ms_per_ktok", rec) == pytest.approx(0.75e3 / 0.15)
    assert value("decode_iter_ms", rec) == pytest.approx(250.0)


def test_mfu_readers():
    rec = record()
    d = ref.dims(CFG)
    per_tok = 2 * (8 * (2 + 2) * 4 + 2 * 4 * 8 + 8 * 4 + 2 * 3 * 8 * 6)
    assert ref.token_flops(d) == per_tok
    head = 2 * 8 * 10
    pre = sum(2 * (P * per_tok + 4 * 4 * 2 * P * (P + 1) // 2) + head
              for P in (100, 50))
    assert value("mfu.prefill", rec) == pytest.approx(
        100 * pre / 0.75 / 989e12)
    dec = sum(3 * (2 * per_tok + head) + 2 * 4 * 4 * 2 * sum(k)
              for k in ([101, 11, 21], [102, 12, 22]))
    assert value("mfu.decode", rec) == pytest.approx(100 * dec / 0.5 / 989e12)


def test_slice_readers():
    rec = record()
    for name in ("flash_fwd_roofline", "decode_attn_roofline", "device_idle"):
        assert value(name, rec) is None
    rec.slice = {"prefills": 2, "flash_s": 0.004, "flash_bound_s": 0.001,
                 "decodes": 5, "decode_s": 0.01, "decode_bound_s": 0.006,
                 "busy_s": 0.3, "wall_s": 0.4}
    assert value("flash_fwd_roofline", rec) == pytest.approx(25.0)
    assert value("decode_attn_roofline", rec) == pytest.approx(60.0)
    assert value("device_idle", rec) == pytest.approx(25.0)


def test_readers_find_nothing_in_an_empty_window():
    loop = SimpleNamespace(iterations=[], served={})
    rec = run.Record(CFG, ref, loop, 0.0, 1.0, None, 1.0, None)
    for name in ("tok_s", "ttft_p90_ms", "tpot_p90_ms", "j_per_tok",
                 "prefill_ms_per_ktok", "decode_iter_ms", "mfu.prefill",
                 "mfu.decode", "power_w"):
        assert value(name, rec) is None
