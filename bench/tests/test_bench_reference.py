"""The plain reference against repro_torch's plain path (the kernels' CPU
versions), at reduced sizes of both configurations, in float32: prefill
into slots of a shared cache, then decode steps over every row, the
engine's way. The weights are biased so that every token routes to expert
0 and the prompts overflow its capacity and drop tokens."""
import numpy as np
import pytest
import torch

from _small import CONFIGS, small_config
from bench.program import moe_transformer as program
from bench.reference import moe_transformer as ref

PROMPTS = (40, 23, 57)


def served_by_program(cfg, W, steps=6):
    model, params = program.build(cfg, W)
    max_len = 128
    cache = model.init_cache(len(PROMPTS), max_len, device="cpu",
                             dtype=torch.float32)
    g = np.random.default_rng(0)
    prompts = [g.integers(1, cfg["vocab_size"], n) for n in PROMPTS]
    tokens = [[] for _ in prompts]
    logits = [[] for _ in prompts]
    for i, p in enumerate(prompts):
        lg, cache = model.prefill(params, {"tokens": torch.as_tensor(p)[None]},
                                  max_len, cache=cache, slot=i)
        tokens[i].append(int(lg[0].argmax()))
        logits[i].append(lg[0])
    for _ in range(steps):
        feed = torch.tensor([[t[-1]] for t in tokens])
        lg, cache = model.decode_step(params, {"tokens": feed}, cache)
        for i in range(len(prompts)):
            tokens[i].append(int(lg[i].argmax()))
            logits[i].append(lg[i])
    return prompts, tokens, [torch.stack(x).float() for x in logits]


@pytest.mark.parametrize("name", CONFIGS)
def test_reference_matches_the_program_in_float32(name):
    cfg = small_config(name, dtype="float32")
    W = ref.draw(cfg, 2**31 + 17, "cpu")
    W["embed"] += 2.0           # every token leans one way, and the
    W["router"][:, :, 0] += 0.5  # router sends that way to expert 0
    prompts, tokens, got = served_by_program(cfg, W)
    d = ref.dims(cfg)
    # the prompts do overflow expert 0: drops are exercised
    h = W["embed"][torch.as_tensor(prompts[2])].float()
    h = h * torch.rsqrt(h.square().mean(-1, keepdim=True) + d.eps)
    top = torch.topk(h @ W["router"][0].float(), d.K, dim=-1).indices
    assert int((top == 0).sum()) > ref.capacity(d, PROMPTS[2])
    seqs = [(torch.as_tensor(np.concatenate([p, t[:-1]])), len(p))
            for p, t in zip(prompts, tokens)]
    want = ref.served_logits(W, cfg, seqs)
    for g, w, t in zip(got, want, tokens):
        assert g.shape == w.shape
        assert float(((g - w).abs().amax(1) / w.std(1)).max()) < 1e-5
        assert float(ref.logit_gaps(w, torch.tensor(t)).max()) == 0.0


def test_capacity_keeps_the_first_tokens_of_each_row():
    d = ref.dims(dict(small_config("qwen3-moe-30b-a3b"), num_experts=2,
                      num_experts_per_tok=1))
    # row 0: 20 tokens, capacity 16, all to expert 1; row 1 one token
    idx = torch.ones((21, 1), dtype=torch.long)
    row = torch.tensor([0] * 20 + [1])
    keep = ref._keep(idx, row, d)[:, 0]
    assert ref.capacity(d, 20) == 16
    assert keep[:16].all() and not keep[16:20].any() and keep[20]
