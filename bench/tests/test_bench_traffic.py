"""The traffic generator: seeds, the paper's length rule, the closed loop."""
import itertools
import json

import numpy as np
import pytest

from _small import ROOT, small_config
from bench import traffic

MIXES = ("paper-c32", "paper-c16", "prefill-pool-c4")


def mix(name):
    return json.loads((ROOT / "bench" / "traffic" / f"{name}.json").read_text())


def take(m, seed, n):
    return list(itertools.islice(traffic.stream(m, seed, 1000), n))


@pytest.mark.parametrize("name", MIXES)
def test_same_seed_same_stream(name):
    a, b = take(mix(name), 2**31 + 3, 70), take(mix(name), 2**31 + 3, 70)
    assert all(np.array_equal(x.prompt, y.prompt) and x.new_tokens == y.new_tokens
               for x, y in zip(a, b))
    c = take(mix(name), 2**31 + 4, 70)
    assert any(not np.array_equal(x.prompt, y.prompt) for x, y in zip(a, c))


@pytest.mark.parametrize("name", MIXES)
def test_every_seed_serves_the_same_lengths(name):
    m = mix(name)
    n = m["block"]
    for seed in (1, 2**31 + 9):
        reqs = take(m, seed, 2 * n)
        for block in (reqs[:n], reqs[n:]):
            got = sorted((len(r.prompt), r.new_tokens) for r in block)
            assert got == sorted(zip(*map(list, traffic.block_lengths(m))))
        assert len(reqs[0].prompt) + reqs[0].new_tokens == max(
            len(r.prompt) + r.new_tokens for r in reqs[:n])


def test_zipf_pmf_is_the_ports():
    from repro_torch.sim import requests

    class Spy:
        def choice(self, support, size, p):
            self.support, self.p = support, p
            return support[:size]
    spy = Spy()
    requests.zipf_lengths(spy, 5, 0.6, 128, 4096)
    support, probs = traffic.zipf_probs(0.6, 128, 4096)
    assert np.array_equal(support, spy.support) and np.array_equal(probs, spy.p)


def test_pd_split_is_the_ports():
    from repro_torch.workloads.stream import generate_stream
    from repro_torch.sim.requests import WorkloadConfig
    s = generate_stream(WorkloadConfig(n_requests=500, length_dist="zipf",
                                       zipf_theta=0.6, min_len=128,
                                       max_len=4096, pd_ratio=20.0))
    P, D = traffic.split_pd(s.prefill_tokens + s.decode_tokens, 20.0)
    assert np.array_equal(P, s.prefill_tokens) and np.array_equal(D, s.decode_tokens)


def test_paper_mix_means():
    P, D = traffic.block_lengths(dict(mix("paper-c32"), block=4096))
    assert 1450 < P.mean() < 1500 and 70 < D.mean() < 78


@pytest.mark.parametrize("clients,slots", [(3, 3), (4, 2)])
def test_clients_never_exceed_n_outstanding(clients, slots):
    import torch  # noqa: F401
    from bench.loop import ClosedLoop
    from bench.program import moe_transformer as program
    from bench.reference import moe_transformer as ref
    from repro_torch.serve.engine import ServingEngine
    cfg = small_config("qwen3-moe-30b-a3b")
    m = {"clients": clients, "slots": slots, "max_len": 64, "block": 6,
         "total": {"dist": "zipf", "theta": 0.6, "lo": 8, "hi": 40},
         "pd_ratio": 3}
    model, params = program.build(cfg, ref.draw(cfg, 5, "cpu"))
    eng = ServingEngine(model, params, max_slots=slots, max_len=64, device="cpu")
    loop = ClosedLoop(eng, traffic.stream(m, 5, 256), clients)
    for _ in range(60):
        loop.step()
        outstanding = len(eng.waiting) + sum(s is not None for s in eng.slots)
        assert outstanding == clients
    assert len(eng.done) > clients
