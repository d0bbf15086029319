"""The training path, JAX reference against the PyTorch port, on the CPU.

Data, AdamW, the flash backward's plain version (against ``jax.grad`` of the
reference's custom-VJP flash core), every family's loss and gradients, the
train step with and without gradient accumulation, remat, checkpoints, the
fault-tolerant runner and the launcher. The same weights (the reference's
``init(PRNGKey(0))`` at ``reduced_config``, converted through numpy, float32)
and the same seeded batches go through both packages. Tolerances: losses
1e-5 relative, gradients 1e-4 relative Frobenius per leaf, the optimizer
1e-6, one AdamW step's parameters at the reference test's rtol 5e-3 / atol
5e-4 (on the first step the update is about lr * sign(g), so the gradients
themselves are held tightly).
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import reduced_config as jax_reduced_config
from repro.configs.base import AttentionConfig as JaxAttentionConfig
from repro.models import attention as jax_attention
from repro.models import build_model as jax_build_model
from repro.train import optimizer as jax_opt
from repro.train.data import DataConfig as JaxDataConfig
from repro.train.data import SyntheticLM as JaxSyntheticLM
from repro.train.trainer import make_train_step as jax_make_train_step
from repro_torch.configs import get_config, reduced_config
from repro_torch.kernels.flash_attention import (FlashAttention,
                                                 attention_forward_reference,
                                                 flash_attention,
                                                 flash_attention_bwd)
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.launch import train as train_launcher
from repro_torch.models import build_model
from repro_torch.models.convert import opt_state_from_numpy, params_from_numpy
from repro_torch.train import optimizer as opt
from repro_torch.train.checkpoint import (CheckpointManager, latest_step,
                                          restore_checkpoint, save_checkpoint)
from repro_torch.train.data import DataConfig, SyntheticLM
from repro_torch.train.fault_tolerance import (FaultToleranceConfig,
                                               FaultTolerantRunner,
                                               StepWatchdog)
from repro_torch.train.trainer import (accumulated, batch_to, make_train_step,
                                       make_value_and_grad, param_dict)

FAMILIES = ["smollm-360m", "qwen3-moe-30b-a3b", "rwkv6-1.6b", "zamba2-1.2b",
            "qwen2-vl-2b", "hubert-xlarge"]
SEQ, BATCH = 32, 2


def _np(x):
    return np.asarray(x.detach().float() if isinstance(x, torch.Tensor) else x,
                      np.float32)


def _rel(a, b, floor: float = 0.0) -> float:
    """Relative Frobenius distance of a from b, relative to at least
    ``floor`` (absolute where both are 0)."""
    a, b = _np(a).astype(np.float64), _np(b).astype(np.float64)
    nb = max(np.linalg.norm(b), floor)
    return float(np.linalg.norm(a - b) / (nb if nb > 0 else 1.0))


def _hold_grads(got, want, tol: float):
    """Per leaf within ``tol`` relative Frobenius; a leaf whose gradient is
    0 in exact arithmetic (a key bias, which shifts every score of a row
    alike) is rounding noise, held relative to 1e-3 of the largest leaf."""
    assert want.keys() == got.keys()
    floor = 1e-3 * max(float(np.linalg.norm(_np(w))) for w in want.values())
    for name, g in got.items():
        assert _rel(g, want[name], floor) <= tol, name


def _pair(arch):
    """(reference model, its params, port model, port params as float32
    masters) of ``arch`` at ``reduced_config`` in float32."""
    jcfg = jax_reduced_config(jax_get_config(arch)).replace(dtype="float32")
    tcfg = reduced_config(get_config(arch)).replace(dtype="float32")
    jmodel = jax_build_model(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    tree = params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams),
                             tcfg, "cpu", dtype=torch.float32)
    return jmodel, jparams, build_model(tcfg), param_dict(tree)


def _named(tree, cfg):
    """A reference tree shaped like the parameters -> the port's names."""
    return param_dict(params_from_numpy(jax.tree_util.tree_map(np.asarray, tree),
                                        cfg, "cpu", dtype=torch.float32))


def _batch(cfg, seed=1, batch=BATCH, seq=SEQ):
    """Tokens and labels, or (stub frontends) frame embeddings and labels."""
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, cfg.vocab_size, (batch, seq)).astype(np.int32)
    if cfg.family == "audio":
        embeds = rng.standard_normal((batch, seq, cfg.d_model)).astype(np.float32)
        return {"embeds": embeds, "labels": labels}
    tokens = rng.integers(1, cfg.vocab_size, (batch, seq)).astype(np.int32)
    return {"tokens": tokens, "labels": labels}


def _jax_loss_and_grads(jmodel, jparams, batch):
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    (loss, metrics), grads = jax.value_and_grad(jmodel.loss_fn, has_aux=True)(
        jparams, jb)
    return loss, metrics, grads


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("vocab,seq,batch,seed,shards", [
    (512, 64, 4, 9, 1), (128, 32, 8, 1, 2), (49152, 128, 2, 0, 1)])
def test_synthetic_batches_equal_the_reference(vocab, seq, batch, seed, shards):
    ours = SyntheticLM(DataConfig(vocab, seq, batch, seed=seed))
    ref = JaxSyntheticLM(JaxDataConfig(vocab, seq, batch, seed=seed))
    for index in (0, 5):
        for shard in range(shards):
            a = ours.batch(index, shard, shards)
            b = ref.batch(index, shard, shards)
            for key in ("tokens", "labels"):
                assert a[key].dtype == b[key].dtype
                np.testing.assert_array_equal(a[key], b[key])


# ---------------------------------------------------------------------------
# optimizer
# ---------------------------------------------------------------------------

def test_schedule_matches_reference():
    cfg = opt.AdamWConfig(lr=1e-3, warmup_steps=10, total_steps=100)
    jcfg = jax_opt.AdamWConfig(lr=1e-3, warmup_steps=10, total_steps=100)
    steps = np.arange(0, 130, 3, dtype=np.int32)
    got = opt.schedule(cfg, torch.from_numpy(steps))
    want = jax_opt.schedule(jcfg, jnp.asarray(steps))
    np.testing.assert_allclose(_np(got), _np(want), rtol=1e-6, atol=1e-12)


def test_adamw_update_matches_reference_over_steps():
    """Three updates of a random tree (a matrix, a vector, a 3-D leaf; one
    gradient large enough to be clipped), from zero moments."""
    rng = np.random.default_rng(3)
    shapes = {"w": (4, 6), "b": (7,), "t": (2, 3, 4)}
    params = {k: rng.standard_normal(s).astype(np.float32) for k, s in shapes.items()}
    cfg = opt.AdamWConfig(lr=1e-2, warmup_steps=2, total_steps=20)
    jcfg = jax_opt.AdamWConfig(lr=1e-2, warmup_steps=2, total_steps=20)
    tp = {k: torch.from_numpy(v) for k, v in params.items()}
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    ts, js = opt.adamw_init(tp), jax_opt.adamw_init(jp)
    for i in range(3):
        grads = {k: (rng.standard_normal(s) * (5.0 if i == 1 else 0.3))
                 .astype(np.float32) for k, s in shapes.items()}
        tp, ts, tm = opt.adamw_update(cfg, {k: torch.from_numpy(v) for k, v in
                                            grads.items()}, ts, tp)
        jp, js, jm = jax_opt.adamw_update(jcfg, {k: jnp.asarray(v) for k, v in
                                                 grads.items()}, js, jp)
        for k in shapes:
            for got, want in ((tp[k], jp[k]), (ts["mu"][k], js["mu"][k]),
                              (ts["nu"][k], js["nu"][k])):
                np.testing.assert_allclose(_np(got), _np(want), rtol=1e-6,
                                           atol=1e-6)
        assert int(ts["step"]) == int(js["step"]) == i + 1
        for key in ("grad_norm", "lr"):
            np.testing.assert_allclose(float(tm[key]), float(jm[key]), rtol=1e-6)


@pytest.mark.parametrize("arch", FAMILIES)
def test_weight_decay_follows_the_reference_leaf_rank(arch):
    """Every port parameter decays as its reference leaf does: a tree whose
    leaves hold their own rank, converted, holds the rank the optimizer
    computes (stacked layers and Zamba2's shared blocks one above the
    port's tensors)."""
    jcfg = jax_reduced_config(jax_get_config(arch)).replace(dtype="float32")
    tcfg = reduced_config(get_config(arch)).replace(dtype="float32")
    jparams = jax_build_model(jcfg).init(jax.random.PRNGKey(0))
    ranks = jax.tree_util.tree_map(
        lambda a: np.full(a.shape, a.ndim, np.float32), jparams)
    for name, p in _named(ranks, tcfg).items():
        assert torch.all(p == opt.reference_ndim(name, p)), name


# ---------------------------------------------------------------------------
# flash attention's backward (plain version) against the reference's VJP
# ---------------------------------------------------------------------------

FLASH_BWD_CASES = [  # (B, S, H, KV, D, causal, window): S pads both chunks
    (2, 50, 4, 4, 16, True, None),
    (1, 50, 6, 2, 32, True, 12),
    (2, 37, 4, 1, 16, False, None),
    (1, 64, 6, 3, 16, False, 20)]


@pytest.mark.parametrize("B,S,H,KV,D,causal,window", FLASH_BWD_CASES)
def test_flash_backward_plain_matches_reference_vjp(B, S, H, KV, D, causal,
                                                    window):
    """``FlashAttention`` on CPU tensors (the plain forward and backward)
    against ``jax.grad`` of ``attention_flash_xla``'s custom-VJP core with
    16-query and 32-key chunks (the tail padded), output gradients drawn at
    random: within 1e-4 of each gradient's largest magnitude."""
    rng = np.random.default_rng(11)
    q, k, v, do = (rng.standard_normal(s).astype(np.float32) for s in
                   ((B, S, H, D), (B, S, KV, D), (B, S, KV, D), (B, S, H, D)))
    cfg = JaxAttentionConfig(n_heads=H, n_kv_heads=KV, head_dim=D,
                             sliding_window=window, causal=causal)

    def jloss(q, k, v):
        out = jax_attention.attention_flash_xla(q, k, v, cfg, q_chunk=16,
                                                kv_chunk=32)
        return jnp.sum(out * do), out

    (_, jout), jgrads = jax.value_and_grad(jloss, argnums=(0, 1, 2),
                                           has_aux=True)(q, k, v)
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    out = FlashAttention.apply(tq, tk, tv, causal, window)
    out.backward(torch.from_numpy(do))
    np.testing.assert_allclose(_np(out), _np(jout), rtol=1e-5, atol=1e-5)
    for got, want in zip((tq.grad, tk.grad, tv.grad), jgrads):
        scale = float(np.abs(_np(want)).max())
        assert np.abs(_np(got) - _np(want)).max() <= 1e-4 * scale


@pytest.mark.parametrize("B,S,H,KV,D,causal,window", FLASH_BWD_CASES)
def test_flash_lse_matches_reference(B, S, H, KV, D, causal, window):
    """The plain forward's lse against the reference's ``_flash_fwd_padded``
    (natural log, (B, H, S))."""
    rng = np.random.default_rng(12)
    q, k, v = (rng.standard_normal(s).astype(np.float32) for s in
               ((B, S, H, D), (B, S, KV, D), (B, S, KV, D)))
    cfg = JaxAttentionConfig(n_heads=H, n_kv_heads=KV, head_dim=D,
                             sliding_window=window, causal=causal)
    cq, ck = 16, 32
    pq, pk = (-S) % cq, (-S) % ck
    G = H // KV
    qc = np.pad(q, ((0, 0), (0, pq), (0, 0), (0, 0))).reshape(B, -1, cq, KV, G, D)
    kc = np.pad(k, ((0, 0), (0, pk), (0, 0), (0, 0))).reshape(B, -1, ck, KV, D)
    vc = np.pad(v, ((0, 0), (0, pk), (0, 0), (0, 0))).reshape(B, -1, ck, KV, D)
    _, jlse = jax_attention._flash_fwd_padded(qc, kc, vc, cfg, cq, ck, S, S)
    # (B, nq, KV, G, cq) -> (B, H, S)
    want = np.asarray(jlse).transpose(0, 2, 3, 1, 4).reshape(B, H, -1)[..., :S]
    tr = lambda x: torch.from_numpy(x).transpose(1, 2)
    _, lse = attention_forward_reference(tr(q), tr(k), tr(v), causal=causal,
                                         window=window)
    np.testing.assert_allclose(_np(lse), want, rtol=1e-5, atol=1e-5)


def test_cpu_training_never_launches_a_kernel():
    q = torch.randn(1, 16, 2, 16, requires_grad=True)
    before = (flash_attention.launches, flash_attention_bwd.launches)
    FlashAttention.apply(q, q, q, True, None).sum().backward()
    assert (flash_attention.launches, flash_attention_bwd.launches) == before


# ---------------------------------------------------------------------------
# every family's loss and gradients
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", FAMILIES)
def test_loss_and_grads_match_reference(arch):
    jmodel, jparams, model, params = _pair(arch)
    batch = _batch(model.cfg)
    jloss, jmetrics, jgrads = _jax_loss_and_grads(jmodel, jparams, batch)
    loss, metrics, grads = make_value_and_grad(model)(params,
                                                      batch_to(batch, "cpu"))
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    np.testing.assert_allclose(float(metrics["aux"]), float(jmetrics["aux"]),
                               rtol=1e-5, atol=1e-7)
    _hold_grads(grads, _named(jgrads, model.cfg), 1e-4)


def test_moe_aux_loss_counts_in_training():
    """Qwen3-MoE's loss is its CE plus the routers' Switch aux loss."""
    _, _, model, params = _pair("qwen3-moe-30b-a3b")
    loss, metrics, _ = make_value_and_grad(model)(
        params, batch_to(_batch(model.cfg), "cpu"))
    assert float(metrics["aux"]) > 0
    assert float(loss) == float(metrics["ce"])


# ---------------------------------------------------------------------------
# the train step
# ---------------------------------------------------------------------------

def _step_pair(arch, grad_accum=1, batch=4):
    jmodel, jparams, model, params = _pair(arch)
    jcfg = jax_opt.AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=20)
    cfg = opt.AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=20)
    return (jmodel, jparams, jax_make_train_step(jmodel, jcfg, grad_accum),
            model, params, make_train_step(model, cfg, grad_accum),
            _batch(model.cfg, batch=batch))


def _hold_step(model, got, want):
    p, o, m = got
    jp, jo, jm = want
    for name, t in _named(jp, model.cfg).items():
        np.testing.assert_allclose(_np(p[name]), _np(t), rtol=5e-3, atol=5e-4,
                                   err_msg=name)
    for key in ("mu", "nu"):
        for name, t in _named(jo[key], model.cfg).items():
            assert _rel(o[key][name], t) <= 1e-4, (key, name)
    assert int(o["step"]) == int(jo["step"])
    for key in ("loss", "ce", "aux", "grad_norm", "lr"):
        np.testing.assert_allclose(float(m[key]), float(jm[key]), rtol=1e-5,
                                   atol=1e-7, err_msg=key)


@pytest.mark.parametrize("arch", ["smollm-360m", "rwkv6-1.6b"])
def test_train_steps_match_reference(arch):
    """Two steps from the same masters: the first from zero moments, the
    second from the reference's own state after its first step, converted
    (``opt_state_from_numpy``)."""
    jmodel, jparams, jstep, model, params, step, batch = _step_pair(arch)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    jout = jstep(jparams, jax_opt.adamw_init(jparams), jb)
    _hold_step(model, step(params, opt.adamw_init(params), batch), jout)
    jp1, jo1, _ = jout
    state = opt_state_from_numpy(jax.tree_util.tree_map(np.asarray, jo1),
                                 model.cfg, "cpu")
    batch2 = _batch(model.cfg, seed=2, batch=4)
    jout2 = jstep(jp1, jo1, {k: jnp.asarray(v) for k, v in batch2.items()})
    _hold_step(model, step(_named(jp1, model.cfg), state, batch2), jout2)


def test_train_step_leaves_its_inputs_unchanged():
    _, _, _, model, params, step, batch = _step_pair("smollm-360m")
    state = opt.adamw_init(params)
    before = {k: v.clone() for k, v in params.items()}
    new, new_state, _ = step(params, state, batch)
    assert all(torch.equal(params[k], before[k]) for k in params)
    assert int(state["step"]) == 0 and int(new_state["step"]) == 1
    assert any(not torch.equal(new[k], params[k]) for k in params)


def test_grad_accum_matches_full_batch():
    """grad_accum 4 against 1 on one batch of 8 (the reference test's
    tolerance), and against the reference's own grad_accum 4."""
    jmodel, jparams, jstep4, model, params, step4, batch = _step_pair(
        "smollm-360m", grad_accum=4, batch=8)
    step1 = make_train_step(model, opt.AdamWConfig(lr=1e-3, warmup_steps=2,
                                                   total_steps=20))
    p1, _, _ = step1(params, opt.adamw_init(params), batch)
    got4 = step4(params, opt.adamw_init(params), batch)
    for name in params:
        np.testing.assert_allclose(_np(got4[0][name]), _np(p1[name]),
                                   rtol=5e-3, atol=5e-4, err_msg=name)
    assert float(got4[2]["aux"]) == 0.0
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    _hold_step(model, got4, jstep4(jparams, jax_opt.adamw_init(jparams), jb))


@pytest.mark.parametrize("grad_accum", [2, 4])
def test_accumulated_gradients_equal_the_full_batch(grad_accum):
    """The mean over the strided microbatches equals the full batch's
    gradient (the loss is a mean over rows of equal length)."""
    _, _, model, params = _pair("smollm-360m")
    vg = make_value_and_grad(model)
    batch = batch_to(_batch(model.cfg, batch=8), "cpu")
    loss, _, full = vg(params, batch)
    aloss, metrics, acc = accumulated(vg, params, batch, grad_accum)
    np.testing.assert_allclose(float(aloss), float(loss), rtol=1e-6)
    assert float(metrics["aux"]) == 0.0
    _hold_grads(acc, full, 1e-5)
    with pytest.raises(ValueError, match="microbatches"):
        accumulated(vg, params, {k: v[:3] for k, v in batch.items()}, 2)


# ---------------------------------------------------------------------------
# remat
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["smollm-360m", "rwkv6-1.6b", "zamba2-1.2b"])
@pytest.mark.parametrize("policy", ["minimal", "dots"])
def test_remat_equals_no_remat(arch, policy, monkeypatch):
    """Loss and gradients under remat equal those without; each layer's
    forward (attention's flash forward) runs again in the backward."""
    _, _, model, params = _pair(arch)
    batch = batch_to(_batch(model.cfg), "cpu")
    calls = []
    fwd = flash_ops.flash_attention_fwd
    monkeypatch.setattr(flash_ops, "flash_attention_fwd",
                        lambda *a, **kw: calls.append(1) or fwd(*a, **kw))
    loss, _, grads = make_value_and_grad(model)(params, batch)
    plain_calls = len(calls)
    remat = build_model(model.cfg, remat=True, remat_policy=policy)
    rloss, _, rgrads = make_value_and_grad(remat)(params, batch)
    np.testing.assert_allclose(float(rloss), float(loss), rtol=1e-6)
    _hold_grads(rgrads, grads, 1e-6)
    if model.cfg.family == "dense":
        assert plain_calls == model.cfg.n_layers
        assert len(calls) - plain_calls == 2 * model.cfg.n_layers
    else:   # Zamba2's shared blocks are not rematerialised, as the reference
        assert len(calls) == 2 * plain_calls


def test_unknown_remat_policy_refused():
    with pytest.raises(ValueError, match="remat policy"):
        build_model(reduced_config(get_config("smollm-360m")),
                    remat_policy="everything")


# ---------------------------------------------------------------------------
# checkpoints (mirroring tests/test_checkpoint_data.py)
# ---------------------------------------------------------------------------

@pytest.fixture
def tree():
    return {"w": torch.arange(12.0).reshape(3, 4),
            "inner": {"b": torch.ones(5, dtype=torch.bfloat16),
                      "step": torch.tensor(7, dtype=torch.int32),
                      "n": np.arange(3, dtype=np.int64)}}


def test_checkpoint_roundtrip(tmp_path, tree):
    save_checkpoint(str(tmp_path), tree, step=3)
    restored, manifest = restore_checkpoint(str(tmp_path), tree)
    assert manifest["step"] == 3
    assert manifest["dtypes"] == ["float32", "bfloat16", "int32", "int64"]
    assert (tmp_path / "step_00000003" / "manifest.json").exists()
    assert torch.equal(restored["w"], tree["w"])
    assert restored["inner"]["b"].dtype == torch.bfloat16
    assert torch.equal(restored["inner"]["b"], tree["inner"]["b"])
    assert int(restored["inner"]["step"]) == 7
    np.testing.assert_array_equal(restored["inner"]["n"], tree["inner"]["n"])


def test_checkpoint_uncommitted_invisible(tmp_path, tree):
    save_checkpoint(str(tmp_path), tree, step=1)
    p = save_checkpoint(str(tmp_path), tree, step=2)
    os.remove(os.path.join(p, "COMMIT"))  # a crash mid-write
    assert latest_step(str(tmp_path)) == 1


def test_checkpoint_async_manager_retention(tmp_path, tree):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    for s in (1, 2, 3, 4):
        mgr.save_async(tree, s)
    mgr.wait()
    mgr._gc()
    steps = sorted(int(d.name.split("_")[1]) for d in tmp_path.glob("step_*"))
    assert steps == [3, 4]
    assert latest_step(str(tmp_path)) == 4
    assert [t[0] for t in mgr.timings] == [1, 2, 3, 4]


def test_checkpoint_shape_mismatch_refused(tmp_path, tree):
    save_checkpoint(str(tmp_path), tree, step=1)
    bad = dict(tree, w=torch.zeros(2, 2))
    with pytest.raises(ValueError, match="leaf 0"):
        restore_checkpoint(str(tmp_path), bad)


def test_checkpoint_of_a_training_state(tmp_path):
    """(params, opt_state) round trips leaf for leaf, parameters in
    ``named_parameters()`` order, then mu, nu and step."""
    _, _, model, params = _pair("smollm-360m")
    state = opt.adamw_init(params)
    state["step"] += 5
    save_checkpoint(str(tmp_path), (params, state), step=5)
    like = ({k: torch.zeros_like(v) for k, v in params.items()},
            opt.adamw_init(params))
    (p, s), manifest = restore_checkpoint(str(tmp_path), like)
    assert manifest["n_leaves"] == 3 * len(params) + 1
    assert list(p) == list(params) and int(s["step"]) == 5
    assert all(torch.equal(p[k], params[k]) for k in params)


# ---------------------------------------------------------------------------
# end to end (mirroring tests/test_train_serve_integration.py)
# ---------------------------------------------------------------------------

def _tiny_model():
    cfg = reduced_config(get_config("stablelm-1.6b")).replace(
        name="tiny", n_layers=2, d_model=64, vocab_size=128, dtype="float32")
    return build_model(cfg)


def test_training_loss_decreases():
    model = _tiny_model()
    params = param_dict(model.init(0, device="cpu", dtype=torch.float32))
    step = make_train_step(model, opt.AdamWConfig(lr=2e-3, warmup_steps=5,
                                                  total_steps=60))
    state = opt.adamw_init(params)
    ds = SyntheticLM(DataConfig(vocab_size=128, seq_len=32, global_batch=8,
                                seed=1))
    losses = []
    for i in range(50):
        params, state, m = step(params, state, ds.batch(i))
        losses.append(float(m["loss"]))
    assert np.mean(losses[-10:]) < np.mean(losses[:10]) - 0.3, \
        f"no learning: {losses[:3]} -> {losses[-3:]}"


def test_fault_tolerant_restart(tmp_path):
    model = _tiny_model()
    params0 = param_dict(model.init(0, device="cpu", dtype=torch.float32))
    step = make_train_step(model, opt.AdamWConfig(lr=1e-3))
    ds = SyntheticLM(DataConfig(vocab_size=128, seq_len=32, global_batch=8,
                                seed=3))
    ft_cfg = FaultToleranceConfig(ckpt_dir=str(tmp_path), ckpt_every=5)
    runner = FaultTolerantRunner(step, ft_cfg)
    runner.run(params0, opt.adamw_init(params0), ds.batch, n_steps=12,
               log_fn=lambda s: None)
    runner.manager.wait()
    assert latest_step(str(tmp_path)) == 12
    # "crash" and restart: resumes from the last commit, not from scratch
    runner2 = FaultTolerantRunner(step, ft_cfg)
    p, o, start = runner2.try_restore(params0, opt.adamw_init(params0))
    assert start == 12 and int(o["step"]) == 12
    out2 = runner2.run(p, o, ds.batch, n_steps=20, start_step=start,
                       log_fn=lambda s: None)
    assert out2["final_step"] == 20
    assert len(out2["losses"]) == 8


def test_fault_tolerant_runner_rejects_a_non_finite_step(tmp_path):
    """A step whose loss is NaN leaves the parameters as they were."""
    model = _tiny_model()
    params0 = param_dict(model.init(0, device="cpu", dtype=torch.float32))
    step = make_train_step(model, opt.AdamWConfig(lr=1e-3))

    def poisoned(params, state, batch):
        p, s, m = step(params, state, batch)
        return p, s, dict(m, loss=torch.tensor(float("nan")))

    ds = SyntheticLM(DataConfig(vocab_size=128, seq_len=32, global_batch=8))
    runner = FaultTolerantRunner(poisoned, FaultToleranceConfig(
        ckpt_dir=str(tmp_path), ckpt_every=100))
    out = runner.run(params0, opt.adamw_init(params0), ds.batch, n_steps=2,
                     log_fn=lambda s: None)
    assert runner.nan_rejections == 2 and out["losses"] == []
    assert all(torch.equal(out["params"][k], params0[k]) for k in params0)


def test_straggler_watchdog():
    wd = StepWatchdog(factor=2.0, window=10)
    for _ in range(8):
        assert not wd.observe(1.0)
    assert wd.observe(5.0)
    assert wd.straggler_events == 1


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["smollm-360m", "rwkv6-1.6b"])
def test_launcher_trains_and_restarts_on_cpu(arch, tmp_path, capsys):
    argv = ["--arch", arch, "--reduced", "--steps", "3", "--ckpt-dir",
            str(tmp_path)]
    out = train_launcher.main(argv, device="cpu")
    assert out["final_step"] == 3 and len(out["losses"]) == 3
    assert all(np.isfinite(out["losses"]))
    assert latest_step(str(tmp_path)) == 3
    again = train_launcher.main(argv[:-3] + ["5", "--ckpt-dir", str(tmp_path)],
                                device="cpu")
    assert again["start_step"] == 3 and again["final_step"] == 5
    assert "done: step 5" in capsys.readouterr().out


@pytest.mark.parametrize("variant", ["baseline", "sp"])
def test_launcher_accepts_variants_at_one_device(variant, tmp_path):
    out = train_launcher.main(["--reduced", "--steps", "1", "--variant",
                               variant, "--ckpt-dir", str(tmp_path)],
                              device="cpu")
    assert out["final_step"] == 1


def test_launcher_refuses_a_mesh():
    """--mesh 2x4 needs an 8-rank process group; without one (a world of
    one) the launcher names both sizes."""
    with pytest.raises(RuntimeError, match="needs 8 ranks; this world has 1"):
        train_launcher.main(["--reduced", "--mesh", "2x4"], device="cpu")


def test_launcher_without_a_card_raises(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_launcher.main(["--reduced", "--steps", "1", "--ckpt-dir",
                             str(tmp_path)])
