"""The served slice, JAX reference against the PyTorch port, on the CPU.

The same weights (the reference's ``init(PRNGKey(0))``, converted through
numpy) and the same prompts go through ``repro``'s ``ServingEngine`` with
``attn_impl="pallas"`` (Pallas kernels in interpret mode) and the port's
``ServingEngine`` with ``attn_impl="kernel"`` (the kernels' plain versions on
CPU tensors). Both engines keep a bfloat16 KV cache.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import reduced_config as jax_reduced_config
from repro.models import build_model as jax_build_model
from repro.serve.engine import ServeRequest as JaxServeRequest
from repro.serve.engine import ServingEngine as JaxServingEngine
from repro_torch.configs import get_config, reduced_config
from repro_torch.kernels.decode_attention import decode_attention
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.models import build_model
from repro_torch.models.convert import params_from_numpy
from repro_torch.serve.engine import ServeRequest, ServingEngine

MAX_LEN = 64


def _pair(arch, dtype):
    jcfg = jax_reduced_config(jax_get_config(arch)).replace(dtype=dtype)
    tcfg = reduced_config(get_config(arch)).replace(dtype=dtype)
    jmodel = jax_build_model(jcfg, attn_impl="pallas")
    jparams = jmodel.init(jax.random.PRNGKey(0))
    tparams = params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams),
                                tcfg, "cpu")
    return jmodel, jparams, build_model(tcfg), tparams


def _prompts(n, length, vocab, seed=1):
    # one length for all prompts: the reference jits one prefill for them
    rng = np.random.default_rng(seed)
    return [rng.integers(1, vocab, length) for _ in range(n)]


def _last_logits(jmodel, jparams, tmodel, tparams, prompt):
    jl, _ = jmodel.prefill(jparams, {"tokens": jnp.asarray(prompt, jnp.int32)[None]},
                           max_len=MAX_LEN)
    tl, _ = tmodel.prefill(tparams, {"tokens": torch.as_tensor(prompt)[None]},
                           MAX_LEN)
    return np.asarray(jl, np.float32), tl.float().numpy()


@pytest.mark.parametrize("arch,prompt_len", [
    ("llama3-8b", 12),
    ("h2o-danube-1.8b", 40),   # window 32: prompts longer than the ring cache
])
def test_engine_greedy_tokens_match_reference_f32(arch, prompt_len):
    jmodel, jparams, tmodel, tparams = _pair(arch, "float32")
    prompts = _prompts(3, prompt_len, tmodel.cfg.vocab_size)
    jeng = JaxServingEngine(jmodel, jparams, max_slots=2, max_len=MAX_LEN)
    teng = ServingEngine(tmodel, tparams, max_slots=2, max_len=MAX_LEN,
                         device="cpu")
    for i, p in enumerate(prompts):
        jeng.submit(JaxServeRequest(rid=i, prompt=p, max_new_tokens=4))
        teng.submit(ServeRequest(rid=i, prompt=p, max_new_tokens=4))
    want = {r.rid: r.generated for r in jeng.run()}
    got = {r.rid: r.generated for r in teng.run()}
    assert got == want
    assert max(r.slot for r in teng.done) == 1   # 3 requests reused 2 slots
    assert [l.kind for l in teng.logs] == [l.kind for l in jeng.logs]
    # the CPU path runs the plain versions and never launches a kernel
    assert flash_attention.launches == 0 and decode_attention.launches == 0


@pytest.mark.parametrize("arch,prompt_len", [
    ("llama3-8b", 12),
    ("h2o-danube-1.8b", 40),
    ("stablelm-1.6b", 12),     # partial RoPE, LayerNorm, QKV bias
])
def test_prefill_logits_match_reference_f32(arch, prompt_len):
    pair = _pair(arch, "float32")
    want, got = _last_logits(*pair, _prompts(1, prompt_len, 256)[0])
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_prefill_logits_match_reference_bf16():
    """bf16 rounds at other places in the two frameworks, so only logits are
    compared and greedy tokens are not pinned. The tolerance is 2e-2 of the
    largest logit: bf16 logits of magnitude ~20 lie 0.125 apart, so an
    elementwise 2e-2 would ask for agreement below one bf16 step."""
    pair = _pair("llama3-8b", "bfloat16")
    want, got = _last_logits(*pair, _prompts(1, 12, 256)[0])
    assert np.abs(got - want).max() <= 2e-2 * np.abs(want).max()


def test_engine_matches_sequential_decode():
    """Port of ``test_serving_matches_sequential_decode``: the engine's greedy
    tokens equal a hand-rolled prefill plus decode loop."""
    cfg = reduced_config(get_config("llama3-8b")).replace(dtype="float32")
    model = build_model(cfg)
    params = model.init(2, device="cpu")
    prompt = np.arange(1, 9)
    eng = ServingEngine(model, params, max_slots=2, max_len=MAX_LEN,
                        device="cpu")
    eng.submit(ServeRequest(rid=0, prompt=prompt, max_new_tokens=6))
    engine_tokens = eng.run()[0].generated

    logits, cache = model.prefill(params, {"tokens": torch.as_tensor(prompt)[None]},
                                  MAX_LEN)
    ref = [int(torch.argmax(logits[0]))]
    for _ in range(5):
        logits, cache = model.decode_step(
            params, {"tokens": torch.tensor([[ref[-1]]])}, cache)
        ref.append(int(torch.argmax(logits[0])))
    assert engine_tokens == ref
