"""The VLM (Qwen2-VL: M-RoPE, QKV bias, tied head) and audio (HuBERT:
non-causal encoder) families, JAX reference against the PyTorch port, on
the CPU; and what every family shares: init, the launcher, no kernel
launches on CPU tensors, an unknown family refused.

The same weights (the reference's ``init(PRNGKey(0))`` at ``reduced_config``,
converted through numpy) and the same seeded inputs go through both
packages in float32, logits within 1e-4.
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
from repro.models import layers as jax_layers
from repro.serve.engine import ServeRequest as JaxServeRequest
from repro.serve.engine import ServingEngine as JaxServingEngine
from repro_torch.configs import ASSIGNED, get_config, reduced_config
from repro_torch.kernels.decode_attention import decode_attention
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.gla_scan import gla_scan
from repro_torch.models import build_model, layers
from repro_torch.models.convert import params_from_numpy
from repro_torch.serve.engine import ServeRequest, ServingEngine

VLM = "qwen2-vl-2b"
AUDIO = "hubert-xlarge"
MAX_LEN = 64
TOL = dict(rtol=1e-4, atol=1e-4)


def _np(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else x,
                      np.float32)


def _pair(arch, dtype="float32", impl="kernel"):
    jcfg = jax_reduced_config(jax_get_config(arch)).replace(dtype=dtype)
    tcfg = reduced_config(get_config(arch)).replace(dtype=dtype)
    jmodel = jax_build_model(jcfg, attn_impl="pallas" if impl == "kernel" else impl)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    tparams = params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams),
                                tcfg, "cpu")
    return jmodel, jparams, build_model(tcfg, attn_impl=impl), tparams


def _prompts(n, length, vocab, seed=1):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, vocab, length) for _ in range(n)]


def _grid_positions(B, n_text, rows, cols):
    """M-RoPE ids (B, S, 3) of ``n_text`` text tokens, a rows x cols patch
    grid (t fixed, h and w its row and column) and 3 text tokens after it,
    as Qwen2-VL numbers them: the streams differ inside the grid."""
    pos = [(i, i, i) for i in range(n_text)]
    pos += [(n_text, n_text + r, n_text + c) for r in range(rows)
            for c in range(cols)]
    nxt = n_text + max(rows, cols)
    pos += [(nxt + i,) * 3 for i in range(3)]
    return np.broadcast_to(np.asarray(pos, np.int32), (B, len(pos), 3)).copy()


# ---------------------------------------------------------------------------
# M-RoPE
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("D", [16, 128])
def test_apply_mrope_matches_reference(D):
    B, H, theta = 2, 3, 1e6
    p3 = _grid_positions(B, 4, 3, 4)
    S = p3.shape[1]
    x = np.random.default_rng(0).standard_normal((B, S, H, D)).astype(np.float32)
    want = jax_layers.apply_mrope(jnp.asarray(x), jnp.asarray(p3), theta)
    got = layers.apply_mrope(torch.from_numpy(x), torch.from_numpy(p3), theta)
    np.testing.assert_allclose(_np(got), _np(want), rtol=1e-5, atol=1e-5)
    assert not np.allclose(p3[..., 0], p3[..., 1])     # the streams differ


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_mrope_of_text_positions_is_rope_bit_for_bit(dtype):
    B, S, H, D, theta = 2, 19, 3, 128, 1e6
    x = torch.randn(B, S, H, D, generator=torch.Generator().manual_seed(1)).to(dtype)
    pos = torch.arange(S)
    p3 = pos[None, :, None].expand(B, S, 3)
    got = layers.apply_mrope(x, p3, theta)
    want = layers.apply_rope(x, layers.rope_angles(pos[None], D, 1.0, theta))
    assert torch.equal(got, want)
    assert torch.equal(layers.mrope_streams(D),
                       torch.tensor([0] * 16 + [1] * 24 + [2] * 24))


# ---------------------------------------------------------------------------
# Qwen2-VL
# ---------------------------------------------------------------------------

def test_vlm_prefill_and_decode_match_reference_f32():
    jmodel, jparams, tmodel, tparams = _pair(VLM)
    prompt = _prompts(1, 12, tmodel.cfg.vocab_size)[0]
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
        np.testing.assert_allclose(_np(tl), _np(jl), **TOL)
    assert int(tcache["lengths"][0]) == len(prompt) + 2


@pytest.mark.parametrize("impl", ["kernel", "einsum"])
def test_vlm_prefill_from_embeds_and_grid_positions_matches_reference(impl):
    jmodel, jparams, tmodel, tparams = _pair(VLM, impl=impl)
    p3 = _grid_positions(2, 5, 3, 3)
    S = p3.shape[1]
    emb = np.random.default_rng(2).standard_normal(
        (2, S, tmodel.cfg.d_model)).astype(np.float32)
    jl, _ = jmodel.prefill(jparams, {"embeds": jnp.asarray(emb),
                                     "positions3": jnp.asarray(p3)},
                           max_len=MAX_LEN)
    tl, cache = tmodel.prefill(tparams, {"embeds": torch.from_numpy(emb),
                                         "positions3": torch.from_numpy(p3)},
                               MAX_LEN)
    np.testing.assert_allclose(_np(tl), _np(jl), **TOL)
    # text positions give other logits than the grid's: M-RoPE is in effect
    tl_text, _ = tmodel.prefill(tparams, {"embeds": torch.from_numpy(emb)}, MAX_LEN)
    assert not np.allclose(_np(tl_text), _np(tl), rtol=1e-3, atol=1e-3)
    assert int(cache["lengths"][0]) == S


def test_vlm_engine_greedy_tokens_match_reference_f32():
    jmodel, jparams, tmodel, tparams = _pair(VLM)
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
    assert max(r.slot for r in teng.done) == 1   # 3 requests reused 2 slots
    assert [l.kind for l in teng.logs] == [l.kind for l in jeng.logs]


def test_vlm_decode_matches_prefill():
    """Port of ``test_models_smoke.py::test_decode_matches_prefill_dense``
    for the VLM family (text positions)."""
    cfg = reduced_config(get_config(VLM)).replace(dtype="float32")
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


@pytest.mark.parametrize("arch", [VLM, AUDIO])
def test_stub_family_prefill_logits_match_reference_bf16(arch):
    """bf16 rounds at other places in the two frameworks: logits within 2e-2
    of their largest magnitude (see test_torch_serve's bf16 test)."""
    jmodel, jparams, tmodel, tparams = _pair(arch, "bfloat16")
    emb = np.random.default_rng(4).standard_normal(
        (2, 12, tmodel.cfg.d_model)).astype(np.float32)
    jl, _ = jmodel.prefill(jparams, {"embeds": jnp.asarray(emb)}, max_len=MAX_LEN)
    tl, _ = tmodel.prefill(tparams, {"embeds": torch.from_numpy(emb)}, MAX_LEN)
    want, got = _np(jl), _np(tl)
    assert np.abs(got - want).max() <= 2e-2 * np.abs(want).max()


# ---------------------------------------------------------------------------
# HuBERT: the non-causal encoder
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("impl", ["kernel", "einsum"])
def test_audio_encoder_prefill_matches_reference_f32(impl):
    jmodel, jparams, tmodel, tparams = _pair(AUDIO, impl=impl)
    assert not tmodel.cfg.attention.causal
    emb = np.random.default_rng(5).standard_normal(
        (3, 20, tmodel.cfg.d_model)).astype(np.float32)
    jl, _ = jmodel.prefill(jparams, {"embeds": jnp.asarray(emb)}, max_len=MAX_LEN)
    tl, cache = tmodel.prefill(tparams, {"embeds": torch.from_numpy(emb)}, MAX_LEN)
    assert cache is None and tl.shape == (3, tmodel.cfg.vocab_size)
    np.testing.assert_allclose(_np(tl), _np(jl), **TOL)
    # the same weights under causal attention give other logits: through 2
    # layers the last position reads earlier positions that saw later ones
    causal = build_model(tmodel.cfg.replace(attention=dataclasses.replace(
        tmodel.cfg.attention, causal=True)), attn_impl=impl)
    tl_causal, _ = causal.prefill(tparams, {"embeds": torch.from_numpy(emb)},
                                  MAX_LEN)
    assert not np.allclose(_np(tl_causal), _np(tl), rtol=1e-3, atol=1e-3)


def test_audio_encoder_has_no_decode():
    cfg = reduced_config(get_config(AUDIO))
    model = build_model(cfg)
    params = model.init(0, device="cpu")
    with pytest.raises(ValueError, match="encoder-only"):
        model.init_cache(2, MAX_LEN, device="cpu")
    with pytest.raises(ValueError, match="encoder-only"):
        model.decode_step(params, {"embeds": torch.zeros(2, 1, cfg.d_model)}, {})


# ---------------------------------------------------------------------------
# every family
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", sorted(ASSIGNED))
def test_every_assigned_arch_inits_on_cpu(arch):
    cfg = reduced_config(get_config(arch))
    params = build_model(cfg).init(0, device="cpu")
    jparams = jax_build_model(jax_reduced_config(jax_get_config(arch))).init(
        jax.random.PRNGKey(0))
    n_ref = sum(np.size(a) for a in jax.tree_util.tree_leaves(jparams))
    assert sum(p.numel() for p in params.parameters()) == n_ref


@pytest.mark.parametrize("arch", ["zamba2-1.2b", "qwen3-moe-30b-a3b",
                                  "mixtral-8x22b", VLM, AUDIO])
def test_new_families_raise_without_a_card(monkeypatch, arch):
    """``None`` means the card for the new families too: without one,
    weights, caches and the launcher raise instead of using the host."""
    from repro_torch.launch.serve import main
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    model = build_model(reduced_config(get_config(arch)))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        model.init(0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["--arch", arch, "--requests", "1"])
    if not model.cfg.is_encoder_only:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            model.init_cache(2, MAX_LEN)


def test_unknown_family_still_raises():
    cfg = reduced_config(get_config("llama3-8b")).replace(family="diffusion")
    with pytest.raises(NotImplementedError, match="diffusion"):
        build_model(cfg).init(0, device="cpu")


@pytest.mark.parametrize("arch", ["zamba2-1.2b", "qwen3-moe-30b-a3b",
                                  "mixtral-8x22b", VLM])
def test_new_decoders_served_through_the_launcher_on_cpu(arch):
    from repro_torch.launch.serve import main
    out = main(["--arch", arch, "--requests", "3", "--slots", "2",
                "--new-tokens", "3"], device="cpu")
    assert out["requests"] == 3 and out["tokens"] == 9
    assert out["energy_wh"] > 0


def test_launcher_refuses_the_encoder_before_drawing_weights(monkeypatch):
    from repro_torch.launch import serve

    def no_weights(*args, **kwargs):
        raise AssertionError("weights were drawn for an encoder-only model")

    monkeypatch.setattr(serve, "build_model", no_weights)
    with pytest.raises(SystemExit, match="hubert-xlarge-reduced is encoder-only: "
                                         "no decode serving"):
        serve.main(["--arch", AUDIO], device="cpu")
    with pytest.raises(SystemExit, match="encoder-only"):
        serve.main(["--arch", AUDIO, "--no-reduced"], device="cpu")


@pytest.mark.parametrize("arch", sorted(ASSIGNED))
def test_cpu_runs_never_launch_a_kernel(arch):
    cfg = reduced_config(get_config(arch))
    model = build_model(cfg)
    params = model.init(0, device="cpu")
    if cfg.embed_stub:
        batch = {"embeds": torch.randn(1, 19, cfg.d_model,
                                       generator=torch.Generator().manual_seed(0))}
    else:
        batch = {"tokens": torch.arange(1, 20)[None]}
    _, cache = model.prefill(params, batch, 32)
    if not cfg.is_encoder_only:
        model.decode_step(params, {"tokens": torch.tensor([[3]])}, cache)
    assert flash_attention.launches == decode_attention.launches == 0
    assert gla_scan.launches == 0
