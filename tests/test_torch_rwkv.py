"""RWKV6 and the GLA scan, JAX reference against the PyTorch port, on the CPU.

On CPU tensors the port's ``gla_scan`` runs its plain version (the
token-by-token scan); these tests hold it against ``repro``'s Pallas kernel
(interpret mode) on the ``tests/test_kernels.py`` sweep, hold the port's
``linear_attention`` against the reference's, and serve reduced RWKV6 with
the reference's weights (``init(PRNGKey(0))``, converted through numpy)
through both packages. The CUDA kernel itself runs only on the card:
``tests/test_torch_card.py`` holds it against the plain version there.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import reduced_config as jax_reduced_config
from repro.kernels.gla_scan import gla_scan as jax_gla_scan
from repro.kernels.gla_scan import gla_scan_reference as jax_gla_scan_ref
from repro.models import build_model as jax_build_model
from repro.models import linear_attention as jax_la
from repro.serve.engine import ServeRequest as JaxServeRequest
from repro.serve.engine import ServingEngine as JaxServingEngine
from repro_torch.configs import get_config, reduced_config
from repro_torch.kernels.gla_scan import gla_scan
from repro_torch.kernels.gla_scan import ops as gla_ops
from repro_torch.models import build_model
from repro_torch.models import linear_attention as la
from repro_torch.models.convert import params_from_numpy
from repro_torch.serve.engine import ServeRequest, ServingEngine

ARCH = "rwkv6-1.6b"
MAX_LEN = 64
DTYPES = {"float32": (torch.float32, jnp.float32),
          "bfloat16": (torch.bfloat16, jnp.bfloat16)}
GLA_SHAPES = [(1, 64, 2, 32, 32),
              (2, 130, 2, 64, 64),    # unpadded T
              (1, 256, 4, 16, 64)]    # K != V (mamba: K=d_state, V=head_dim)


def _np(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else x,
                      np.float32)


def _gla_inputs(seed, dtype, B, T, H, K, V, mode, lo=-6.0, hi=2.5):
    """Normal q/k/v, strong-decay log w = -exp(U(lo, hi)) and (rwkv) a bonus,
    rounded to ``dtype``: (torch tensors, jax arrays)."""
    rng = np.random.default_rng(seed)
    arrays = [rng.standard_normal(s, dtype=np.float32)
              for s in ((B, T, H, K), (B, T, H, K), (B, T, H, V))]
    arrays.append(-np.exp(rng.uniform(lo, hi, (B, T, H, K))).astype(np.float32))
    arrays.append(0.3 * rng.standard_normal((H, K), dtype=np.float32)
                  if mode == "rwkv" else None)
    tdt, jdt = DTYPES[dtype]
    ts = [None if a is None else torch.from_numpy(a).to(tdt) for a in arrays]
    js = [None if t is None else jnp.asarray(t.float().numpy(), jdt) for t in ts]
    return ts, js


# ---------------------------------------------------------------------------
# (a) gla_scan: the port's plain version against the Pallas kernel
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("B,T,H,K,V", GLA_SHAPES)
@pytest.mark.parametrize("mode", ["ssd", "rwkv"])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_gla_scan_matches_reference(B, T, H, K, V, mode, dtype):
    (q, k, v, lw, u), (jq, jk, jv, jlw, ju) = _gla_inputs(3, dtype, B, T, H,
                                                          K, V, mode)
    o, s = gla_scan(q, k, v, lw, u=u, mode=mode, chunk=32)
    assert o.shape == v.shape and o.dtype == v.dtype
    assert s.shape == (B, H, K, V) and s.dtype == torch.float32
    jo, js = jax_gla_scan(jq, jk, jv, jlw, u=ju, mode=mode, chunk=32,
                          interpret=True)
    tr = lambda x: x.transpose(0, 2, 1, 3)
    ro, rs = jax_gla_scan_ref(tr(jq), tr(jk), tr(jv), tr(jlw), u=ju, mode=mode)
    tol = dict(rtol=5e-2, atol=5e-2) if dtype == "bfloat16" \
        else dict(rtol=2e-4, atol=2e-4)
    for got, pallas, oracle in ((o, jo, tr(ro)), (s, js, rs)):
        assert np.isfinite(_np(got)).all()
        np.testing.assert_allclose(_np(got), _np(pallas), **tol)
        np.testing.assert_allclose(_np(got), _np(oracle), **tol)


@pytest.mark.parametrize("change,error", [
    (dict(K=8), ValueError),                 # K below 16
    (dict(K=80), ValueError),                # K above 64
    (dict(V=24), ValueError),                # V not a multiple of 16
    (dict(kv_dtype=torch.float16), TypeError),
    (dict(u=None), ValueError),              # rwkv without its bonus
    (dict(), ValueError),                    # all fine but on the CPU
])
def test_gla_scan_wrapper_checks(change, error):
    """The kernel's wrapper raises on what the kernel does not take; the
    last case shows that a tensor off the card never reaches a launch."""
    K, V = change.get("K", 32), change.get("V", 32)
    dt = change.get("kv_dtype", torch.float32)
    q = torch.zeros(1, 8, 2, K, dtype=dt)
    v = torch.zeros(1, 8, 2, V, dtype=dt)
    u = change.get("u", torch.zeros(2, K))
    with pytest.raises(error):
        gla_ops._check(q, q, v, q.float(), u, "rwkv")
    with pytest.raises(ValueError, match="unknown mode"):
        gla_scan(q, q, v, q.float(), u=u, mode="gla")


# ---------------------------------------------------------------------------
# (b) linear_attention against the reference's
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", ["ssd", "rwkv"])
def test_gla_chunked_and_reference_match_reference(mode):
    B, T, H, K, V = 2, 100, 2, 32, 48
    (q, k, v, lw, u), (jq, jk, jv, jlw, ju) = _gla_inputs(
        4, "float32", B, T, H, K, V, "rwkv", hi=3.0)
    if mode == "ssd":
        u, ju = None, None
    tol = dict(rtol=1e-4, atol=1e-4)
    o_c, s_c = la.gla_chunked(q, k, v, lw, u=u, mode=mode, chunk=16)
    o_r, s_r = la.gla_reference(q, k, v, lw, u=u, mode=mode)
    jo_c, js_c = jax_la.gla_chunked(jq, jk, jv, jlw, u=ju, mode=mode, chunk=16)
    jo_r, js_r = jax_la.gla_reference(jq, jk, jv, jlw, u=ju, mode=mode)
    for got, want in ((o_c, jo_c), (s_c, js_c), (o_r, jo_r), (s_r, js_r),
                      (o_c, jo_r), (s_c, js_r)):
        np.testing.assert_allclose(_np(got), _np(want), **tol)


@pytest.mark.parametrize("mode", ["ssd", "rwkv"])
def test_gla_step_and_initial_state_match_reference(mode):
    B, T, H, K, V = 2, 20, 2, 16, 32
    (q, k, v, lw, u), (jq, jk, jv, jlw, ju) = _gla_inputs(
        5, "float32", B, T, H, K, V, "rwkv")
    if mode == "ssd":
        u, ju = None, None
    s0 = np.random.default_rng(6).standard_normal((B, H, K, V)).astype(np.float32)
    o, s = la.gla_step(q[:, 0], k[:, 0], v[:, 0], lw[:, 0], torch.from_numpy(s0),
                       u=u, mode=mode)
    jo, js = jax_la.gla_step(jq[:, 0], jk[:, 0], jv[:, 0], jlw[:, 0],
                             jnp.asarray(s0), u=ju, mode=mode)
    np.testing.assert_allclose(_np(o), _np(jo), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(_np(s), _np(js), rtol=1e-4, atol=1e-4)
    # a carried state: the chunked scan from s0 against the reference's
    o_c, s_c = la.gla_chunked(q, k, v, lw, u=u, mode=mode, chunk=8,
                              initial_state=torch.from_numpy(s0))
    jo_c, js_c = jax_la.gla_chunked(jq, jk, jv, jlw, u=ju, mode=mode, chunk=8,
                                    initial_state=jnp.asarray(s0))
    np.testing.assert_allclose(_np(o_c), _np(jo_c), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(_np(s_c), _np(js_c), rtol=1e-4, atol=1e-4)


# ---------------------------------------------------------------------------
# (c, d) reduced RWKV6 served by both packages
# ---------------------------------------------------------------------------

def _pair(dtype, impl="kernel"):
    jcfg = jax_reduced_config(jax_get_config(ARCH)).replace(dtype=dtype)
    tcfg = reduced_config(get_config(ARCH)).replace(dtype=dtype)
    jmodel = jax_build_model(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    tparams = params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams),
                                tcfg, "cpu")
    return jmodel, jparams, build_model(tcfg, attn_impl=impl), tparams


def _prompts(n, length, vocab, seed=1):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, vocab, length) for _ in range(n)]


@pytest.mark.parametrize("impl", ["kernel", "einsum"])
def test_rwkv_prefill_and_decode_match_reference_f32(impl):
    jmodel, jparams, tmodel, tparams = _pair("float32", impl)
    prompt = _prompts(1, 37, tmodel.cfg.vocab_size)[0]   # ragged last chunk
    jl, jcache = jmodel.prefill(
        jparams, {"tokens": jnp.asarray(prompt, jnp.int32)[None]}, max_len=MAX_LEN)
    tl, tcache = tmodel.prefill(tparams, {"tokens": torch.as_tensor(prompt)[None]},
                                MAX_LEN)
    np.testing.assert_allclose(_np(tl), _np(jl), rtol=1e-4, atol=1e-4)
    for key in ("tm_shift", "cm_shift", "wkv"):
        np.testing.assert_allclose(_np(tcache[key]), _np(jcache[key]),
                                   rtol=1e-4, atol=1e-4)
    assert int(tcache["lengths"][0]) == len(prompt)
    for tok in (5, 77):
        jl, jcache = jmodel.decode_step(
            jparams, {"tokens": jnp.asarray([[tok]], jnp.int32)}, jcache)
        tl, tcache = tmodel.decode_step(tparams, {"tokens": torch.tensor([[tok]])},
                                        tcache)
        np.testing.assert_allclose(_np(tl), _np(jl), rtol=1e-4, atol=1e-4)
    assert int(tcache["lengths"][0]) == len(prompt) + 2


def test_rwkv_engine_greedy_tokens_match_reference_f32():
    jmodel, jparams, tmodel, tparams = _pair("float32")
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


def test_rwkv_reused_slot_starts_clean():
    """A prompt served in a slot that held (and kept decoding) another
    sequence gives the tokens it gives in a fresh engine."""
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


def test_rwkv_decode_matches_prefill():
    """Port of ``test_models_smoke.py::test_decode_matches_prefill_rwkv``."""
    cfg = reduced_config(get_config(ARCH)).replace(dtype="float32")
    model = build_model(cfg)
    params = model.init(4, device="cpu")
    S = 8
    toks = torch.from_numpy(np.random.default_rng(4).integers(
        0, cfg.vocab_size, (1, S + 1)))
    logits_full, _ = model.prefill(params, {"tokens": toks}, 32)
    _, cache = model.prefill(params, {"tokens": toks[:, :S]}, 32)
    logits_dec, _ = model.decode_step(params, {"tokens": toks[:, S:]}, cache)
    np.testing.assert_allclose(_np(logits_full), _np(logits_dec), rtol=2e-2,
                               atol=2e-2)


def test_rwkv_prefill_logits_match_reference_bf16():
    """bf16 rounds at other places in the two frameworks: logits within 2e-2
    of their largest magnitude (see test_torch_serve's bf16 test)."""
    jmodel, jparams, tmodel, tparams = _pair("bfloat16")
    prompt = _prompts(1, 12, tmodel.cfg.vocab_size)[0]
    jl, _ = jmodel.prefill(jparams, {"tokens": jnp.asarray(prompt, jnp.int32)[None]},
                           max_len=MAX_LEN)
    tl, _ = tmodel.prefill(tparams, {"tokens": torch.as_tensor(prompt)[None]},
                           MAX_LEN)
    want, got = _np(jl), _np(tl)
    assert np.abs(got - want).max() <= 2e-2 * np.abs(want).max()


def test_rwkv_served_through_the_launcher_on_cpu():
    from repro_torch.launch.serve import main
    out = main(["--arch", ARCH, "--requests", "3", "--slots", "2",
                "--new-tokens", "3"], device="cpu")
    assert out["requests"] == 3 and out["tokens"] == 9
    assert out["energy_wh"] > 0


# ---------------------------------------------------------------------------
# (e) the CPU path never launches the kernel
# ---------------------------------------------------------------------------

def test_cpu_runs_never_launch_gla_scan():
    before = gla_scan.launches
    q = torch.randn(1, 40, 2, 16)
    gla_scan(q, q, q, -torch.rand(1, 40, 2, 16), u=torch.zeros(2, 16), mode="rwkv")
    cfg = reduced_config(get_config(ARCH))
    model = build_model(cfg)
    params = model.init(0, device="cpu")
    model.prefill(params, {"tokens": torch.arange(1, 20)[None]}, 32)
    assert gla_scan.launches == before == 0
