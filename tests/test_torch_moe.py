"""The MoE family, JAX reference against the PyTorch port, on the CPU.

The same weights (the reference's ``init(PRNGKey(0))`` at ``reduced_config``,
converted through numpy) and the same seeded inputs go through both
packages in float32: ``apply_moe``'s dispatch must match exactly (experts,
kept tokens, slots), including a case where capacity drops tokens and a
case with tied router probabilities; logits within 1e-4. Reduced
Qwen3-MoE has 4 experts top-2; reduced Mixtral the same, with a 32-token
window that a 40-token prompt passes. With the span profiler on, the MoE's
counts equal a hand count of the dispatch, and an engine serves the same
tokens and cache bits as with it off, its spans nested as the served path
nests.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import reduced_config as jax_reduced_config
from repro.models import build_model as jax_build_model
from repro.models import moe as jax_moe
from repro.serve.engine import ServeRequest as JaxServeRequest
from repro.serve.engine import ServingEngine as JaxServingEngine
from repro_torch.configs import get_config, reduced_config
from repro_torch.models import build_model
from repro_torch.models import moe
from repro_torch.models.convert import params_from_numpy
from repro_torch.obs.spans import PROFILER
from repro_torch.serve.engine import ServeRequest, ServingEngine

ARCHS = ["qwen3-moe-30b-a3b", "mixtral-8x22b"]
# Mixtral's prompt passes its reduced 32-token window
PROMPT_LEN = {"qwen3-moe-30b-a3b": 12, "mixtral-8x22b": 40}
MAX_LEN = 64


@pytest.fixture(autouse=True)
def _profiler_clean():
    yield
    PROFILER.disable()
    PROFILER.reset()


def _np(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else x,
                      np.float32)


def _pair(arch, dtype="float32"):
    jcfg = jax_reduced_config(jax_get_config(arch)).replace(dtype=dtype)
    tcfg = reduced_config(get_config(arch)).replace(dtype=dtype)
    jmodel = jax_build_model(jcfg, attn_impl="pallas")
    jparams = jmodel.init(jax.random.PRNGKey(0))
    tparams = params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams),
                                tcfg, "cpu")
    return jmodel, jparams, build_model(tcfg), tparams


def _prompts(n, length, vocab, seed=1):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, vocab, length) for _ in range(n)]


# ---------------------------------------------------------------------------
# apply_moe
# ---------------------------------------------------------------------------

def _moe_inputs(arch, case, S):
    """Layer 0's MoE weights of the reference's init and seeded x (2, S, D).
    ``drops``: feature 0 of x is 1 and router[0, 0] is 30, so expert 0 is
    every token's first choice and overflows its capacity. ``ties``: the
    router's columns 2 and 3 copy column 1, so experts 1-3 tie on every
    token."""
    jcfg = jax_reduced_config(jax_get_config(arch))
    params = jax_build_model(jcfg).init(jax.random.PRNGKey(0))
    p = {k: np.array(v[0], np.float32)
         for k, v in params["layers"]["moe"].items()}
    x = np.random.default_rng(3).standard_normal((2, S, jcfg.d_model),
                                                 dtype=np.float32)
    if case == "drops":
        x[..., 0] = 1.0
        p["router"][0, 0] = 30.0
    elif case == "ties":
        p["router"][:, 2] = p["router"][:, 1]
        p["router"][:, 3] = p["router"][:, 1]
    return jcfg, p, x


@pytest.mark.parametrize("case", ["random", "drops", "ties"])
@pytest.mark.parametrize("arch", ARCHS)
def test_apply_moe_matches_reference(arch, case):
    S = 24   # capacity 16 of 48 assignments over 4 experts: drops possible
    jcfg, p, x = _moe_inputs(arch, case, S)
    cfg = reduced_config(get_config(arch))
    E, K = cfg.moe.n_experts, cfg.moe.top_k
    C = moe.capacity_for(S, cfg.moe)
    assert C == jax_moe.capacity_for(S, jcfg.moe) == 16

    # the reference's routing and per-row dispatch metadata
    jx = jnp.asarray(x)
    probs = jax.nn.softmax(jx @ jnp.asarray(p["router"]), axis=-1)
    jgates, jidx = jax.lax.top_k(probs, K)
    jgates = jgates / jnp.maximum(jgates.sum(-1, keepdims=True), 1e-9)
    _, (jtoken, _, jkeep, jdest) = jax.vmap(
        lambda xt, pr, ix, gv: jax_moe._dispatch_row(xt, pr, ix, gv, E, K, C)
    )(jx, probs, jidx, jgates)
    jout, jaux = jax_moe.apply_moe(jx, {k: jnp.asarray(v) for k, v in p.items()},
                                   jcfg.moe)

    tp = moe.MoEParams(*(torch.from_numpy(p[k]) for k in
                         ("router", "up", "gate", "down")))
    tx = torch.from_numpy(x)
    _, gates, idx = moe.route(tx, tp, cfg.moe)
    order, keep, dest, _, _ = moe.dispatch(idx, E, C)
    out, aux = moe.apply_moe(tx, tp, cfg.moe)

    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_array_equal((order // K).numpy(), np.asarray(jtoken))
    np.testing.assert_array_equal(keep.numpy(), np.asarray(jkeep))
    np.testing.assert_array_equal(dest.numpy(), np.asarray(jdest))
    np.testing.assert_allclose(_np(gates), _np(jgates), rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(_np(out), _np(jout), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-5)
    if case == "drops":
        assert not keep.all()          # capacity dropped some assignments
    elif case == "random":
        assert keep.all()
    if case == "ties":
        # experts 1-3 tie everywhere: the lower index wins, never 3
        assert (idx == 3).sum() == 0 and ((idx == 1) & (idx.roll(-1, -1) == 2)).any()


@pytest.mark.parametrize("case", ["random", "drops"])
def test_moe_counts_match_a_hand_count_of_the_dispatch(case):
    """``model.moe``'s counts against the dispatch's keep mask counted by
    hand; under ``drops`` expert 0 overflows in both rows."""
    arch = "qwen3-moe-30b-a3b"
    S = 24
    _, p, x = _moe_inputs(arch, case, S)
    cfg = reduced_config(get_config(arch))
    E, K = cfg.moe.n_experts, cfg.moe.top_k
    C = moe.capacity_for(S, cfg.moe)
    tp = moe.MoEParams(*(torch.from_numpy(p[k]) for k in
                         ("router", "up", "gate", "down")))
    tx = torch.from_numpy(x)
    _, _, idx = moe.route(tx, tp, cfg.moe)
    order, keep, _, _, _ = moe.dispatch(idx, E, C)
    flat = idx.reshape(2, S * K)
    kept_experts = {int(flat[b, order[b, j]]) for b in range(2)
                    for j in range(S * K) if keep[b, j]}
    PROFILER.enable(reset=True)
    with PROFILER.span("model.moe"):
        out, _ = moe.apply_moe(tx, tp, cfg.moe)
    PROFILER.disable()
    torch.testing.assert_close(out, moe.apply_moe(tx, tp, cfg.moe)[0],
                               rtol=0, atol=0)
    rec = next(r for r in PROFILER.records() if r.name == "model.moe")
    assert rec.counts == {
        "assigned": 2 * S * K, "kept": int(keep.sum()),
        "routed": len(kept_experts), "slots": 2 * E * C,
        "d_model": cfg.d_model, "d_expert": cfg.moe.d_expert}
    if case == "drops":
        assert rec.counts["kept"] < rec.counts["assigned"]


@pytest.mark.parametrize("arch", ARCHS)
def test_traced_engine_serves_the_same_tokens_and_cache(arch):
    """Spans on: the same tokens and cache bits as spans off; each
    ``moe.*`` span under ``model.moe`` under a served iteration; a
    ``serve.queued`` for each request prefilled, from its submission to
    its prefill's start."""
    cfg = reduced_config(get_config(arch))
    model = build_model(cfg)
    params = model.init(0, device="cpu")
    prompts = _prompts(3, PROMPT_LEN[arch], cfg.vocab_size)

    def serve():
        eng = ServingEngine(model, params, max_slots=2, max_len=MAX_LEN,
                            device="cpu")
        for i, p in enumerate(prompts):
            eng.submit(ServeRequest(rid=i, prompt=p, max_new_tokens=4))
        return {r.rid: r.generated for r in eng.run()}, eng.cache

    want, cache_off = serve()
    PROFILER.enable(reset=True)
    got, cache_on = serve()
    PROFILER.disable()
    assert got == want
    for key in ("k", "v", "lengths"):
        assert torch.equal(cache_on[key], cache_off[key]), key

    recs = PROFILER.records()
    by_sid = {r.sid: r for r in recs}

    def chain(r):
        names = []
        while r.parent is not None:
            r = by_sid[r.parent]
            names.append(r.name)
        return names

    stages = [r for r in recs if r.name.startswith("moe.")]
    assert {r.name for r in stages} == {"moe.route", "moe.dispatch",
                                        "moe.experts", "moe.combine"}
    for r in stages + [r for r in recs if r.name == "trace.count"]:
        up = chain(r)
        assert up[0] == "model.moe" and up[-1] in ("serve.decode",
                                                   "serve.prefill"), up
    iters = [r for r in recs if r.name in ("serve.prefill", "serve.decode")]
    n_moe = sum(r.name == "model.moe" for r in recs)
    assert n_moe == len(iters) * cfg.n_layers
    queued = {r.rid: r for r in recs if r.name == "serve.queued"}
    prefills = {r.rid: r for r in recs if r.name == "serve.prefill"}
    assert set(queued) == set(prefills) == {0, 1, 2}
    for rid, q in queued.items():
        assert q.t0 <= q.t1 <= prefills[rid].t0
    # the third request waits for a slot through the first one's decode
    assert queued[2].t1 - queued[2].t0 > queued[0].t1 - queued[0].t0


def test_capacity_matches_reference():
    jcfg = jax_reduced_config(jax_get_config("qwen3-moe-30b-a3b")).moe
    for full in (False, True):
        cfg = get_config("qwen3-moe-30b-a3b").moe
        jc = jax_get_config("qwen3-moe-30b-a3b").moe if full else jcfg
        tc = cfg if full else reduced_config(get_config("qwen3-moe-30b-a3b")).moe
        for S in (1, 7, 8, 24, 100, 2048, 6000):
            for cf in (1.0, 1.25, 2.0):
                assert moe.capacity_for(S, tc, cf) == jax_moe.capacity_for(S, jc, cf)


# ---------------------------------------------------------------------------
# reduced MoE models served by both packages
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_moe_prefill_and_decode_match_reference_f32(arch):
    jmodel, jparams, tmodel, tparams = _pair(arch)
    prompt = _prompts(1, PROMPT_LEN[arch], tmodel.cfg.vocab_size)[0]
    jl, jcache = jmodel.prefill(
        jparams, {"tokens": jnp.asarray(prompt, jnp.int32)[None]}, max_len=MAX_LEN)
    tl, tcache = tmodel.prefill(tparams, {"tokens": torch.as_tensor(prompt)[None]},
                                MAX_LEN)
    np.testing.assert_allclose(_np(tl), _np(jl), rtol=1e-4, atol=1e-4)
    for tok in (5, 77):
        jl, jcache = jmodel.decode_step(
            jparams, {"tokens": jnp.asarray([[tok]], jnp.int32)}, jcache)
        tl, tcache = tmodel.decode_step(tparams, {"tokens": torch.tensor([[tok]])},
                                        tcache)
        np.testing.assert_allclose(_np(tl), _np(jl), rtol=1e-4, atol=1e-4)
    assert int(tcache["lengths"][0]) == len(prompt) + 2


@pytest.mark.parametrize("arch", ARCHS)
def test_moe_engine_greedy_tokens_match_reference_f32(arch):
    jmodel, jparams, tmodel, tparams = _pair(arch)
    prompts = _prompts(3, PROMPT_LEN[arch], tmodel.cfg.vocab_size)
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


@pytest.mark.parametrize("arch", ARCHS)
def test_moe_decode_matches_prefill(arch):
    """Port of ``test_models_smoke.py::test_decode_matches_prefill_dense``
    for the MoE family."""
    cfg = reduced_config(get_config(arch)).replace(dtype="float32")
    model = build_model(cfg, attn_impl="einsum")
    params = model.init(3, device="cpu")
    S = 8
    toks = torch.from_numpy(np.random.default_rng(3).integers(
        0, cfg.vocab_size, (1, S + 1)))
    logits_full, _ = model.prefill(params, {"tokens": toks}, 32)
    _, cache = model.prefill(params, {"tokens": toks[:, :S]}, 32)
    logits_dec, _ = model.decode_step(params, {"tokens": toks[:, S:]}, cache)
    np.testing.assert_allclose(_np(logits_full), _np(logits_dec), rtol=2e-2,
                               atol=2e-2)


def test_moe_prefill_logits_match_reference_bf16():
    """bf16 rounds at other places in the two frameworks: logits within 2e-2
    of their largest magnitude (see test_torch_serve's bf16 test)."""
    jmodel, jparams, tmodel, tparams = _pair("qwen3-moe-30b-a3b", "bfloat16")
    prompt = _prompts(1, 12, tmodel.cfg.vocab_size)[0]
    jl, _ = jmodel.prefill(jparams, {"tokens": jnp.asarray(prompt, jnp.int32)[None]},
                           max_len=MAX_LEN)
    tl, _ = tmodel.prefill(tparams, {"tokens": torch.as_tensor(prompt)[None]},
                           MAX_LEN)
    want, got = _np(jl), _np(tl)
    assert np.abs(got - want).max() <= 2e-2 * np.abs(want).max()
