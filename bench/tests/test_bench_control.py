"""The control of the output check: the plain reference computed in float8
(e4m3), the precision below the configurations' bf16, in the program's
place for its served tokens and its cache rows. On the CPU its rounding; on
the card (``cuda``) the control at a cell's own size, which has to read
above one of the cell's limits while the program reads below all of them."""
import json

import numpy as np
import pytest
import torch

from _small import ROOT, small_config
from bench.reference import moe_transformer as ref


def test_fp8_rounding():
    x = torch.randn(64, 256, generator=torch.Generator().manual_seed(0)) * 3
    q = ref._fp8(x, dim=-1)
    # at most half an e4m3 step (3 mantissa bits) of each row's scale away,
    # the row's largest kept exactly
    scale = x.abs().amax(-1, keepdim=True)
    assert torch.equal(q.abs().amax(-1), x.abs().amax(-1))
    assert float(((q - x).abs() / torch.maximum(x.abs(), scale / 2 ** 8)).max()) <= 2 ** -4
    assert torch.equal(ref._fp8(q, dim=-1), q)


def test_fp8_control_moves_the_logits():
    cfg = small_config("mixtral-8x22b-pp4")
    W = ref.draw(cfg, 3, "cpu")
    tokens = torch.arange(1, 40)
    full = ref.served_logits(W, cfg, [(tokens, 30)])[0]
    low = ref.served_logits(W, cfg, [(tokens, 30)], fp8=True)[0]
    assert full.shape == low.shape == (10, cfg["vocab_size"])
    assert 0 < float(((full - low).abs().amax(1) / full.std(1)).max()) < 1


CELLS = ("qwen3moe-paper-c32", "mixtral-pp4-paper-c16", "qwen3moe-prefill-pool")


@pytest.mark.cuda
@pytest.mark.parametrize("workload", CELLS)
def test_control_fails_where_the_program_passes(workload):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the control runs at the cell's size")
    from bench import check, run
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    s = run.serve(workload, 2**31 + 1234, spec["run_seconds"], False)
    limits = s.limits["check"]
    picked = check.sample(s.rec.done_in_window, np.random.default_rng(1),
                          limits["served_tokens"], limits["sequence_tokens"])
    logits, ref_kv = check.reference_pass(s.ref, s.W, s.cfg, picked, s.snap)
    low, fp8_kv = check.reference_pass(s.ref, s.W, s.cfg, picked, s.snap,
                                       fp8=True)
    P = len(s.snap.prompt)
    program = check.numbers(
        np.concatenate(check.served_gaps(s.ref, logits, picked)),
        check.kv_errors(s.snap.k, s.snap.v, ref_kv, P))
    control = check.numbers(
        np.concatenate(check.control_gaps(s.ref, logits, low)),
        check.kv_errors([k for k, _ in fp8_kv], [v for _, v in fp8_kv],
                        ref_kv, P))
    for name, value in program.items():
        assert value <= limits[name], (name, value)
    assert any(control[name] > limits[name] for name in program), control
