"""Zamba2 (Mamba2 backbone + shared attention), JAX reference against the
PyTorch port, on the CPU.

The same weights (the reference's ``init(PRNGKey(0))`` at ``reduced_config``,
converted through numpy) and the same seeded inputs go through both
packages in float32, within 1e-4. ``reduced_config`` applies the shared
block before every layer (``shared_attn_every=1``); a variant with 5 layers
and ``shared_attn_every=3`` has a short last segment and reuses copy
``g % 2``. The port's prefill scan runs through ``gla_scan`` in ``ssd``
mode with ``attn_impl="kernel"`` (its plain version on CPU tensors) and
through ``gla_chunked`` with ``"einsum"``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import reduced_config as jax_reduced_config
from repro.models import build_model as jax_build_model
from repro.models import mamba as jax_mamba
from repro.models import zamba as jax_zamba
from repro.serve.engine import ServeRequest as JaxServeRequest
from repro.serve.engine import ServingEngine as JaxServingEngine
from repro_torch.configs import get_config, reduced_config
from repro_torch.kernels.gla_scan import gla_scan
from repro_torch.models import build_model, mamba, zamba
from repro_torch.models.convert import params_from_numpy
from repro_torch.serve.engine import ServeRequest, ServingEngine

ARCH = "zamba2-1.2b"
MAX_LEN = 64
TOL = dict(rtol=1e-4, atol=1e-4)
# the reduced config, and one whose 5 layers form segments of 3 and 2
VARIANTS = {"every1": {}, "every3": {"n_layers": 5, "shared_attn_every": 3}}


def _np(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else x,
                      np.float32)


def _close_cache(got, want):
    """A bf16 cache entry within one bf16 step (2^-7 relative) of the
    reference's: the two compute K and V in float32 to within ~1e-6, and an
    entry that lies at a rounding boundary rounds to neighbouring bf16
    values; float32 states within TOL."""
    tol = dict(rtol=2 ** -7, atol=1e-4) if got.dtype == torch.bfloat16 else TOL
    np.testing.assert_allclose(_np(got), _np(want), **tol)


def _close_decode(got, want):
    """Decode outputs within 1e-4 of their largest magnitude: decode reads
    the bf16 K/V cache, where one entry a bf16 step apart (``_close_cache``)
    moves outputs by ~1e-5 of their scale (from the same cache the two
    decodes agree to below 1e-5)."""
    want = _np(want)
    np.testing.assert_allclose(_np(got), want, rtol=1e-4,
                               atol=1e-4 * np.abs(want).max())


def _configs(variant="every1", dtype="float32"):
    kw = dict(VARIANTS[variant])
    every = kw.pop("shared_attn_every", None)
    out = []
    for cfg in (jax_reduced_config(jax_get_config(ARCH)),
                reduced_config(get_config(ARCH))):
        cfg = cfg.replace(dtype=dtype, **kw)
        if every is not None:
            cfg = cfg.replace(zamba=dataclasses.replace(
                cfg.zamba, shared_attn_every=every))
        out.append(cfg)
    return out


def _pair(variant="every1", dtype="float32", impl="kernel"):
    jcfg, tcfg = _configs(variant, dtype)
    jmodel = jax_build_model(jcfg, attn_impl="pallas")
    jparams = jmodel.init(jax.random.PRNGKey(0))
    tparams = params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams),
                                tcfg, "cpu")
    return jmodel, jparams, build_model(tcfg, attn_impl=impl), tparams


def _prompts(n, length, vocab, seed=1):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, vocab, length) for _ in range(n)]


# ---------------------------------------------------------------------------
# the Mamba2 block
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("impl", ["kernel", "einsum"])
def test_mamba_block_prefill_and_decode_match_reference(impl):
    jcfg, tcfg = _configs()
    jparams = jax_build_model(jcfg).init(jax.random.PRNGKey(0))
    lp = {k: np.asarray(v[0], np.float32) for k, v in jparams["layers"].items()}
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams), tcfg,
                           "cpu").layers[0]
    B, T = 2, 37                                  # a ragged last chunk
    x = np.random.default_rng(5).standard_normal((B, T + 2, tcfg.d_model)
                                                 ).astype(np.float32)
    jlp = {k: jnp.asarray(v) for k, v in lp.items()}
    jout, (jcx, jcbc), jssm = jax_mamba.mamba_block(
        jnp.asarray(x[:, :T]), jlp, jcfg, mode="train")
    out, (cx, cbc), ssm = mamba.mamba_block(torch.from_numpy(x[:, :T]), tp, tcfg,
                                            mode="prefill", impl=impl)
    for got, want in ((out, jout), (cx, jcx), (cbc, jcbc), (ssm, jssm)):
        assert got.shape == want.shape
        np.testing.assert_allclose(_np(got), _np(want), **TOL)
    for t in (T, T + 1):                          # two decode steps
        jout, (jcx, jcbc), jssm = jax_mamba.mamba_block(
            jnp.asarray(x[:, t:t + 1]), jlp, jcfg, conv_state=(jcx, jcbc),
            ssm_state=jssm, mode="decode")
        out, (cx, cbc), ssm = mamba.mamba_block(
            torch.from_numpy(x[:, t:t + 1]), tp, tcfg, conv_state=(cx, cbc),
            ssm_state=ssm, mode="decode")
        for got, want in ((out, jout), (cx, jcx), (cbc, jcbc), (ssm, jssm)):
            np.testing.assert_allclose(_np(got), _np(want), **TOL)


def test_mamba_init_constants_match_reference():
    jcfg, tcfg = _configs()
    want = jax_mamba.mamba_block_params(jax.random.PRNGKey(0), jcfg)
    got = mamba.mamba_block_params(tcfg, torch.Generator().manual_seed(0),
                                   torch.device("cpu"), torch.float32)
    for key in ("A_log", "dt_bias", "D_skip", "norm_scale", "conv_x_b", "conv_bc_b"):
        np.testing.assert_allclose(_np(getattr(got, key)), _np(want[key]),
                                   rtol=1e-6, atol=1e-7)
    for key, w in want.items():
        assert tuple(getattr(got, key).shape) == w.shape, key


# ---------------------------------------------------------------------------
# the hybrid stack
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("impl", ["kernel", "einsum"])
@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_zamba_forward_matches_reference(variant, impl):
    jcfg, tcfg = _configs(variant)
    jparams = jax_build_model(jcfg).init(jax.random.PRNGKey(0))
    tparams = params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams),
                                tcfg, "cpu")
    B, S = 2, 21
    x = np.random.default_rng(6).standard_normal((B, S + 1, tcfg.d_model)
                                                 ).astype(np.float32)
    # the reference's Pallas kernels (interpret mode) beside the port's
    # kernel path: the plain decode rounds its softmax weights to the cache's
    # bf16, the kernels keep them in float32
    jimpl = {"kernel": "pallas", "einsum": "einsum"}[impl]
    jh, jpre, _ = jax_zamba.zamba_forward(
        jparams, jcfg, jnp.asarray(x[:, :S]), positions=jnp.arange(S)[None],
        mode="prefill", attn_impl=jimpl)
    h, pre = zamba.zamba_forward(tparams, tcfg, torch.from_numpy(x[:, :S]),
                                 positions=torch.arange(S)[None],
                                 mode="prefill", attn_impl=impl)
    np.testing.assert_allclose(_np(h), _np(jh), **TOL)
    assert sorted(pre) == sorted(jpre)
    for key in pre:
        assert tuple(pre[key].shape) == jpre[key].shape, key
        np.testing.assert_allclose(_np(pre[key]), _np(jpre[key]), **TOL)

    jcache = jax_zamba.fill_zamba_cache_from_prefill(jcfg, jpre, S, MAX_LEN, B)
    cache = zamba.fill_zamba_cache_from_prefill(tcfg, pre, S, MAX_LEN, B)
    assert sorted(cache) == sorted(jcache)
    for key in cache:
        assert cache[key].dtype == {"k": torch.bfloat16, "v": torch.bfloat16,
                                    "lengths": torch.int32}.get(key, torch.float32)
        _close_cache(cache[key], jcache[key])

    lengths = jcache["lengths"]
    jh, jcache, _ = jax_zamba.zamba_forward(
        jparams, jcfg, jnp.asarray(x[:, S:]), positions=lengths[:, None],
        mode="decode", cache=jcache, attn_impl=jimpl)
    h, cache = zamba.zamba_forward(
        tparams, tcfg, torch.from_numpy(x[:, S:]),
        positions=cache["lengths"][:, None], mode="decode", cache=cache,
        attn_impl=impl)
    _close_decode(h, jh)
    for key in cache:
        _close_cache(cache[key], jcache[key])


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_zamba_prefill_and_decode_logits_match_reference_f32(variant):
    jmodel, jparams, tmodel, tparams = _pair(variant)
    prompt = _prompts(1, 19, tmodel.cfg.vocab_size)[0]
    jl, jcache = jmodel.prefill(
        jparams, {"tokens": jnp.asarray(prompt, jnp.int32)[None]}, max_len=MAX_LEN)
    tl, tcache = tmodel.prefill(tparams, {"tokens": torch.as_tensor(prompt)[None]},
                                MAX_LEN)
    np.testing.assert_allclose(_np(tl), _np(jl), **TOL)
    for tok in (5, 77):
        jl, jcache = jmodel.decode_step(
            jparams, {"tokens": jnp.asarray([[tok]], jnp.int32)}, jcache)
        tl, tcache = tmodel.decode_step(tparams, {"tokens": torch.tensor([[tok]])},
                                        tcache)
        _close_decode(tl, jl)
    assert int(tcache["lengths"][0]) == len(prompt) + 2


def test_zamba_engine_greedy_tokens_match_reference_f32():
    jmodel, jparams, tmodel, tparams = _pair()
    prompts = _prompts(3, 12, tmodel.cfg.vocab_size)
    jeng = JaxServingEngine(jmodel, jparams, max_slots=2, max_len=MAX_LEN)
    teng = ServingEngine(tmodel, tparams, max_slots=2, max_len=MAX_LEN,
                         device="cpu")
    for i, p in enumerate(prompts):
        jeng.submit(JaxServeRequest(rid=i, prompt=p, max_new_tokens=4))
        teng.submit(ServeRequest(rid=i, prompt=p, max_new_tokens=4))
    want = {r.rid: r.generated for r in jeng.run()}
    got = {r.rid: r.generated for r in teng.run()}
    assert got == want
    assert sorted(r.slot for r in teng.done) == [0, 0, 1]  # slot 0 reused
    assert [l.kind for l in teng.logs] == [l.kind for l in jeng.logs]
    # as the reference's engine, the shared cache keeps k/v in bf16 and the
    # ssm state in float32; float32 conv states replaced the bf16 ones at
    # the first decode step, as the reference's decode returns them
    assert teng.cache["k"].dtype == torch.bfloat16
    assert teng.cache["ssm"].dtype == teng.cache["conv_x"].dtype == torch.float32


def test_zamba_reused_slot_starts_clean():
    """A prompt served in a slot that held (and kept decoding) another
    sequence gives the tokens it gives in a fresh engine: the prefill
    overwrites all three recurrent states of the slot."""
    cfg = reduced_config(get_config(ARCH)).replace(dtype="float32")
    model = build_model(cfg)
    params = model.init(3, device="cpu")
    first, second = _prompts(2, 10, cfg.vocab_size, seed=7)
    fresh = ServingEngine(model, params, max_slots=1, max_len=MAX_LEN, device="cpu")
    fresh.submit(ServeRequest(rid=0, prompt=second, max_new_tokens=5))
    want = fresh.run()[0].generated
    reused = ServingEngine(model, params, max_slots=1, max_len=MAX_LEN, device="cpu")
    reused.submit(ServeRequest(rid=0, prompt=first, max_new_tokens=6))
    reused.submit(ServeRequest(rid=1, prompt=second, max_new_tokens=5))
    done = {r.rid: r for r in reused.run()}
    assert done[1].slot == done[0].slot == 0
    assert done[1].generated == want


def test_zamba_decode_matches_prefill():
    """Port of ``test_models_smoke.py::test_decode_matches_prefill_dense``
    for the hybrid family."""
    cfg = reduced_config(get_config(ARCH)).replace(dtype="float32")
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


def test_zamba_prefill_logits_match_reference_bf16():
    """bf16 rounds at other places in the two frameworks: logits within 2e-2
    of their largest magnitude (see test_torch_serve's bf16 test)."""
    jmodel, jparams, tmodel, tparams = _pair(dtype="bfloat16")
    prompt = _prompts(1, 12, tmodel.cfg.vocab_size)[0]
    jl, _ = jmodel.prefill(jparams, {"tokens": jnp.asarray(prompt, jnp.int32)[None]},
                           max_len=MAX_LEN)
    tl, _ = tmodel.prefill(tparams, {"tokens": torch.as_tensor(prompt)[None]},
                           MAX_LEN)
    want, got = _np(jl), _np(tl)
    assert np.abs(got - want).max() <= 2e-2 * np.abs(want).max()


def test_cpu_zamba_never_launches_gla_scan():
    cfg = reduced_config(get_config(ARCH))
    model = build_model(cfg)
    params = model.init(0, device="cpu")
    model.prefill(params, {"tokens": torch.arange(1, 20)[None]}, 32)
    assert gla_scan.launches == 0
