"""A run's check catches a broken timed path: each cell driven on the CPU
at a reduced size (the harness's look for a card skipped), sound and with
a fault planted underneath, and ``correct`` read. The faults a served cell
can have: a step that leaves its state (the K/V cache) unchanged, a decode
step in the decoding cells and a prefill in the prefill pool (whose product
is that cache); half of the batch left out, its rows given the mean of the
rest's logits; tokens altered where they are produced (one in ten). No cell
exchanges anything between chips. The reduced model computes in float32,
so a sound run reads the reference's tokens and a fault shows plainly."""
import pytest
import torch

from _small import small_config
from bench import run

CELLS = {"qwen3moe-paper-c32": "qwen3-moe-30b-a3b",
         "mixtral-pp4-paper-c16": "mixtral-8x22b-pp4",
         "qwen3moe-prefill-pool": "qwen3-moe-30b-a3b"}
DECODES = ("qwen3moe-paper-c32", "mixtral-pp4-paper-c16")


def state_unchanged(monkeypatch):
    from bench.control import FAULTS
    monkeypatch.setattr(*FAULTS["decode_kv_lost"]())


def prefill_state_unchanged(monkeypatch):
    from bench.control import FAULTS
    monkeypatch.setattr(*FAULTS["prefill_kv_lost"]())


def half_batch(monkeypatch):
    from repro_torch.models.lm import Model
    orig = Model.decode_step

    def decode_step(self, params, batch, cache):
        logits, cache = orig(self, params, batch, cache)
        half = logits.shape[0] // 2
        logits[half:] = logits[:half].mean(0)
        return logits, cache
    monkeypatch.setattr(Model, "decode_step", decode_step)


def token_altered(monkeypatch):
    """Every tenth token the engine produces is altered. (The check is a
    mean over a sample of about a thousand tokens, so a single altered
    token in a run need not show.)"""
    from repro_torch.serve.engine import ServingEngine
    orig = ServingEngine.step
    produced = [0]

    def step(self):
        before = {id(r): len(r.generated) for r in self.slots if r is not None}
        n_done = len(self.done)
        orig(self)
        for r in [s for s in self.slots if s is not None] + self.done[n_done:]:
            if before.get(id(r)) != len(r.generated):
                produced[0] += 1
                if produced[0] % 10 == 0:
                    r.generated[-1] = (r.generated[-1] + 1) % self.model.cfg.vocab_size
    monkeypatch.setattr(ServingEngine, "step", step)


FAULTS = [(c, f) for c in DECODES for f in (state_unchanged, half_batch, token_altered)]
FAULTS += [("qwen3moe-prefill-pool", f)
           for f in (prefill_state_unchanged, token_altered)]


def one_run(workload):
    torch.manual_seed(0)
    cfg = small_config(CELLS[workload], dtype="float32")
    # windows long enough, on a slow host too, that the requests finished
    # in them come from both halves of the slots: the pool's prompts take
    # about a second each here
    seconds = 12.0 if workload == "qwen3moe-prefill-pool" else 3.0
    return run.run_cell(workload, 2**31 + 77, seconds, False, device="cpu",
                        cfg=cfg)


@pytest.mark.parametrize("workload", CELLS)
def test_sound_run_is_correct(workload):
    result = one_run(workload)
    assert result["correct"], result["checks"]
    assert result["attempted"] > 0 and result["failed"] == 0


@pytest.mark.parametrize("workload,fault", FAULTS,
                         ids=[f"{c}-{f.__name__}" for c, f in FAULTS])
def test_fault_makes_the_run_incorrect(workload, fault, monkeypatch):
    fault(monkeypatch)
    result = one_run(workload)
    assert not result["correct"], result["checks"]
