"""The reference's ``auto`` attention and the padded-``lengths`` prefill,
JAX reference against the PyTorch port, on the CPU.

``attention_flash_xla`` (the chunked online softmax and its flash backward,
``FlashCore``) and its varlen path (``kv_valid``) against the reference's,
forward and gradients in float32 within 1e-5, with chunks small enough that
every case spans several q and kv chunks and a ragged last one; ``impl="auto"``
picks the reference's branch on each side of 256 x 256; and a right-padded
ragged batch through ``Model.prefill`` against the reference's ``prefill``
with ``lengths`` for each decode-capable family (reduced configs, float32),
logits and cache at the families' parity tolerances.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import reduced_config as jax_reduced_config
from repro.models import attention as jax_attn
from repro.models import build_model as jax_build_model
from repro_torch.configs import get_config, reduced_config
from repro_torch.configs.base import AttentionConfig
from repro_torch.models import attention as attn
from repro_torch.models import build_model
from repro_torch.models.convert import params_from_numpy

CFG = AttentionConfig(n_heads=4, n_kv_heads=2, head_dim=8)
MASKS = {"causal": {}, "window": {"sliding_window": 7},
         "non_causal": {"causal": False}}
B, S = 2, 37
LENGTHS = np.array([37, 20])
TOL = dict(rtol=1e-5, atol=1e-5)


def _inputs(seed=0, dtype=np.float32):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(B, S, CFG.n_heads, CFG.head_dim)).astype(dtype)
    k = rng.normal(size=(B, S, CFG.n_kv_heads, CFG.head_dim)).astype(dtype)
    v = rng.normal(size=(B, S, CFG.n_kv_heads, CFG.head_dim)).astype(dtype)
    w = rng.normal(size=q.shape).astype(dtype)
    return q, k, v, w


def _jax_cfg(mask):
    from repro.configs.base import AttentionConfig as JaxAttentionConfig
    return JaxAttentionConfig(n_heads=4, n_kv_heads=2, head_dim=8, **MASKS[mask])


@pytest.mark.parametrize("padded", [False, True], ids=["packed", "kv_valid"])
@pytest.mark.parametrize("mask", sorted(MASKS))
def test_flash_xla_forward_and_grad_match_reference(mask, padded):
    q, k, v, w = _inputs()
    valid = np.arange(S)[None, :] < LENGTHS[:, None] if padded else None
    chunks = dict(q_chunk=8, kv_chunk=16)
    jcfg = _jax_cfg(mask)
    tcfg = dataclasses.replace(CFG, **MASKS[mask])

    def jloss(q, k, v):
        out = jax_attn.attention_flash_xla(
            q, k, v, jcfg, kv_valid=None if valid is None else jnp.asarray(valid),
            **chunks)
        return jnp.sum(out * w), out

    (_, jout), jgrads = jax.value_and_grad(jloss, argnums=(0, 1, 2),
                                           has_aux=True)(q, k, v)
    tq, tk, tv = (torch.tensor(a, requires_grad=True) for a in (q, k, v))
    tout = attn.attention_flash_xla(
        tq, tk, tv, tcfg, kv_valid=None if valid is None else torch.tensor(valid),
        **chunks)
    torch.sum(tout * torch.tensor(w)).backward()
    np.testing.assert_allclose(tout.detach().numpy(), np.asarray(jout), **TOL)
    for got, want in zip((tq.grad, tk.grad, tv.grad), jgrads):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_einsum_kv_valid_matches_reference():
    q, k, v, _ = _inputs(1)
    valid = np.arange(S)[None, :] < LENGTHS[:, None]
    want = jax_attn.attention_einsum(q, k, v, _jax_cfg("non_causal"),
                                     kv_valid=jnp.asarray(valid))
    got = attn.attention_einsum(*map(torch.tensor, (q, k, v)),
                                dataclasses.replace(CFG, causal=False),
                                kv_valid=torch.tensor(valid))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("seq", [16, 256, 257])
def test_auto_picks_the_reference_branch(monkeypatch, seq):
    """``auto``: materialized scores up to S x Skv = 256 x 256, the chunked
    path above, in both packages."""
    calls = {"jax": [], "torch": []}
    for mod, key in ((jax_attn, "jax"), (attn, "torch")):
        for name in ("attention_einsum", "attention_flash_xla"):
            orig = getattr(mod, name)
            monkeypatch.setattr(mod, name, lambda *a, _o=orig, _n=name, _k=key,
                                **kw: calls[_k].append(_n) or _o(*a, **kw))
    d = 16
    rng = np.random.default_rng(seq)
    x = rng.normal(size=(1, seq, d)).astype(np.float32)
    jcfg = dataclasses.replace(_jax_cfg("causal"), rope="none")
    jp = jax_attn.attn_params(jax.random.PRNGKey(0), d, jcfg)
    jax_attn.attention_block(jnp.asarray(x), jp, jcfg, positions=None,
                             mode="prefill", impl="auto")
    tp = attn.AttnParams(*(torch.tensor(np.asarray(jp[n]))
                           for n in ("wq", "wk", "wv", "wo")))
    attn.attention_block(torch.tensor(x), tp, dataclasses.replace(CFG, rope="none"),
                         rope=None, mode="prefill", impl="auto")
    assert calls["torch"] == calls["jax"] == [
        "attention_einsum" if seq <= 256 else "attention_flash_xla"]


# ---------------------- the padded-lengths prefill ----------------------

# one arch per decode-capable family (dense, MoE, VLM, ssm, hybrid), and
# a sliding window whose ring the padded prompt overruns
DECODERS = ["llama3-8b", "h2o-danube-1.8b", "qwen3-moe-30b-a3b",
            "qwen2-vl-2b", "rwkv6-1.6b", "zamba2-1.2b"]
PROMPT, MAX_LEN = 40, 64
RAGGED = np.array([40, 17, 5])


def _np(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else x,
                      np.float32)


@functools.lru_cache(maxsize=None)
def _reference_prefill(arch):
    """The reference's weights, a ragged batch and its prefill (jitted)."""
    jcfg = jax_reduced_config(jax_get_config(arch)).replace(dtype="float32")
    jmodel = jax_build_model(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    toks = np.random.default_rng(2).integers(1, jcfg.vocab_size,
                                             (len(RAGGED), PROMPT))
    jl, jcache = jax.jit(functools.partial(jmodel.prefill, max_len=MAX_LEN))(
        jparams, {"tokens": jnp.asarray(toks, jnp.int32),
                  "lengths": jnp.asarray(RAGGED, jnp.int32)})
    return (jax.tree_util.tree_map(np.asarray, jparams), toks, np.asarray(jl),
            jax.tree_util.tree_map(np.asarray, jcache))


@pytest.mark.parametrize("impl", ["auto", "kernel"])
@pytest.mark.parametrize("arch", DECODERS)
def test_ragged_prefill_matches_reference(arch, impl):
    jparams, toks, jl, jcache = _reference_prefill(arch)
    tcfg = reduced_config(get_config(arch)).replace(dtype="float32")
    tparams = params_from_numpy(jparams, tcfg, "cpu")
    tl, tcache = build_model(tcfg, attn_impl=impl).prefill(
        tparams, {"tokens": torch.as_tensor(toks),
                  "lengths": torch.as_tensor(RAGGED)}, MAX_LEN)
    np.testing.assert_allclose(_np(tl), _np(jl), rtol=1e-4, atol=1e-4)
    # every family's cache holds each row's length (the reference's RWKV6 and
    # Zamba2 prefills set S for every row)
    np.testing.assert_array_equal(tcache["lengths"].numpy(), RAGGED)
    assert sorted(tcache) == sorted(jcache)
    for key in sorted(set(tcache) - {"lengths"}):
        got, want = _np(tcache[key]), _np(jcache[key])
        if key in ("k", "v"):   # the slots that hold valid positions
            W = got.shape[2]
            keep = min(PROMPT, W)
            pos = np.zeros(W, int)
            pos[(np.arange(keep) + PROMPT - keep) % W] = \
                np.arange(keep) + PROMPT - keep
            valid = pos[None, :] < RAGGED[:, None]
            got, want = got[:, valid], want[:, valid]
        elif impl == "kernel":
            # the states run over the padding, whose values the flash kernel
            # (no padding mask) leaves other than the reference's: full rows
            full = RAGGED == PROMPT
            got, want = got[:, full], want[:, full]
        tol = (dict(rtol=2 ** -7, atol=1e-4)
               if tcache[key].dtype == torch.bfloat16 else dict(rtol=1e-4, atol=1e-4))
        np.testing.assert_allclose(got, want, **tol, err_msg=key)


def test_non_causal_padded_batch_refuses_the_kernel():
    cfg = reduced_config(get_config("hubert-xlarge")).replace(dtype="float32")
    model = build_model(cfg)
    params = model.init(0, device="cpu")
    batch = {"embeds": torch.zeros(2, 8, cfg.d_model),
             "lengths": torch.tensor([8, 3])}
    with pytest.raises(ValueError, match="padding mask"):
        model.prefill(params, batch, 8)
    logits, cache = build_model(cfg, attn_impl="auto").prefill(params, batch, 8)
    assert logits.shape == (2, cfg.vocab_size) and cache is None
