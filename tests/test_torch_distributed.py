"""The distributed layer, JAX reference against the PyTorch port, on the CPU.

The sharding rules (tp modes, kv_repeat, the logical axes of every
``ASSIGNED`` arch) and the plans: every arch's mapping and plan equal the
reference's on the 1x1, 2x4, 16x16 and 2x16x16 meshes for every kind and
variant. The planning functions read a mesh's axis names and sizes only, so
both packages get a stand-in with a ``shape`` dict and no process group, and
the reference's 16e9 bytes of device memory. Leaf logical tuples equal the
reference's without its stacked layer axis, matched leaf to leaf through
``models.convert``. Compression: the quantize round trip, error feedback,
and q, scales and residuals bitwise equal to the reference's. The pipeline:
a 4-rank gloo group against the reference's shard_map pipeline (2e-5) and
its gradients against sequential autograd (1e-5).
"""
import os
import subprocess
import sys
import textwrap
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _hypothesis_support import given, settings, st
from _torch_dist import run_ranks

from repro.configs import ASSIGNED as JAX_ASSIGNED
from repro.configs import get_config as jax_get_config
from repro.configs import reduced_config as jax_reduced_config
from repro.configs.base import ShapeConfig as JaxShapeConfig
from repro.distributed import compression as jax_comp
from repro.distributed import sharding as jax_sharding
from repro.models import build_model as jax_build_model
from repro_torch.configs import ASSIGNED, get_config, reduced_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.distributed import axes
from repro_torch.distributed import sharding
from repro_torch.distributed.compression import (compress_tree,
                                                 decompress_tree,
                                                 dequantize_int8,
                                                 quantize_int8)
from repro_torch.models import build_model
from repro_torch.models.convert import params_from_numpy
from repro_torch.train.trainer import param_dict

MESHES = {"1x1": {"data": 1, "model": 1}, "2x4": {"data": 2, "model": 4},
          "16x16": {"data": 16, "model": 16},
          "2x16x16": {"pod": 2, "data": 16, "model": 16}}
KINDS = ["train", "prefill", "decode", "decode_b1"]
VARIANTS = ["baseline", "dp", "hd", "sp"]
TPU_V5E_HBM = 16e9


# ---------------------------- sharding rules ----------------------------

def test_tp_modes():
    assert sharding.attention_tp_mode(get_config("stablelm-1.6b"), 16) == "head"
    assert sharding.attention_tp_mode(get_config("smollm-360m"), 16) == "head_dim"
    assert sharding.attention_tp_mode(get_config("qwen2-vl-2b"), 16) == "head_dim"
    assert sharding.attention_tp_mode(get_config("mistral-nemo-12b"), 16) == "head"


def test_kv_repeat():
    assert sharding.kv_repeat_for(get_config("mistral-nemo-12b"), 16) == 2
    assert sharding.kv_repeat_for(get_config("qwen3-moe-30b-a3b"), 16) == 4
    assert sharding.kv_repeat_for(get_config("stablelm-1.6b"), 16) == 1
    assert sharding.kv_repeat_for(get_config("smollm-360m"), 16) == 1


def test_needs_fsdp_defaults_to_one_h100():
    """Serving shards weights over data once bf16 weights pass 45% of the
    device: 80e9 bytes on the H100 by default, the reference's 16e9 when
    asked."""
    cfg = get_config("mistral-nemo-12b")          # ~24.5 GB of bf16 weights
    assert sharding.H100_HBM_BYTES == 80e9
    assert not sharding.needs_fsdp(cfg, 1, "decode")
    assert sharding.needs_fsdp(cfg, 1, "decode", hbm_per_chip=TPU_V5E_HBM)
    assert sharding.needs_fsdp(cfg, 16, "train")


@pytest.mark.parametrize("arch", sorted(ASSIGNED))
def test_logical_axes_cover_all_params(arch):
    """Every parameter gets a logical-axis tuple of its rank."""
    model = build_model(reduced_config(get_config(arch)))
    params = param_dict(model.init(0, device="meta", dtype=torch.float32))
    logical = sharding.param_logical_tree(params)
    assert logical.keys() == params.keys()
    for name, p in params.items():
        assert len(logical[name]) == p.ndim, (arch, name, logical[name])


def _shape(kind):
    if kind == "decode_b1":   # long-context decode: the cache's seq sharded
        return "decode", (524_288, 1)
    return kind, (4_096, 256)


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", sorted(ASSIGNED))
def test_mappings_and_plans_match_reference(arch, mesh):
    """make_mapping and make_plan (mapping and kv_repeat) for every kind and
    variant, batch and cache specs for every leaf name."""
    assert sorted(ASSIGNED) == sorted(JAX_ASSIGNED)
    fake = SimpleNamespace(shape=dict(MESHES[mesh]))
    cfg, jcfg = get_config(arch), jax_get_config(arch)
    for kind in KINDS:
        k, (seq, batch) = _shape(kind)
        shape = ShapeConfig("s", seq, batch, k)
        jshape = JaxShapeConfig("s", seq, batch, k)
        for variant in VARIANTS:
            want = jax_sharding.make_mapping(jcfg, fake, k, jshape, variant)
            got = sharding.make_mapping(cfg, fake, k, shape, variant,
                                        hbm_per_chip=TPU_V5E_HBM)
            assert got == want, (kind, variant)
            jplan = jax_sharding.make_plan(jcfg, fake, k, jshape, variant)
            plan = sharding.make_plan(cfg, fake, k, shape, variant,
                                      hbm_per_chip=TPU_V5E_HBM)
            assert plan.mapping == jplan.mapping, (kind, variant)
            if cfg.attention is not None:
                assert (plan.cfg.attention.kv_repeat
                        == jplan.cfg.attention.kv_repeat), (kind, variant)
            batch_tree = {n: np.zeros(s) for n, s in
                          [("tokens", (2, 3)), ("labels", (2, 3)),
                           ("valid", (2, 3)), ("embeds", (2, 3, 4)),
                           ("positions3", (2, 3, 3)), ("lengths", (2,)),
                           ("other", (2, 3))]}
            jb = jax_sharding.batch_pspecs(jcfg, want, batch_tree)
            tb = sharding.batch_pspecs(cfg, got, batch_tree)
            assert {n: tuple(s) for n, s in tb.items()} == \
                {n: tuple(s) for n, s in jb.items()}
            cache = {n: np.zeros(1) for n in
                     ("k", "v", "lengths", "wkv", "tm_shift", "cm_shift",
                      "ssm", "conv_x", "conv_bc", "other")}
            jc = jax_sharding.cache_pspecs(jcfg, want, cache)
            tc = sharding.cache_pspecs(cfg, got, cache)
            assert {n: tuple(s) for n, s in tc.items()} == \
                {n: tuple(s) for n, s in jc.items()}


def test_logical_to_spec_and_placements():
    from torch.distributed.tensor import Replicate, Shard
    mapping = axes.default_mapping(multi_pod=True)
    spec = axes.logical_to_spec(("batch", "capacity", "heads", "mlp"), mapping)
    # a physical axis appears once: capacity's axes went to batch already
    assert tuple(spec) == (("pod", "data"), None, "model", None)
    assert repr(spec) == "PartitionSpec(('pod', 'data'), None, 'model', None)"
    mesh = SimpleNamespace(mesh_dim_names=("pod", "data", "model"),
                           shape=(2, 1, 4))
    # a mesh dimension of one rank replicates
    assert axes.placements(spec, mesh) == [Shard(0), Replicate(), Shard(2)]
    assert axes.mesh_shape(mesh) == {"pod": 2, "data": 1, "model": 4}
    x = torch.ones(3)
    assert axes.constrain(x, ("batch",)) is x     # no env: a no-op
    with axes.axis_env(mesh, mapping):
        assert axes.constrain(x, ("batch",)) is x   # a plain tensor


def _marked(shapes):
    """The reference's parameter tree with every element of leaf j equal to
    j * 1000 (+ i on the i-th entry of a stacked leaf)."""
    flat, treedef = jax.tree_util.tree_flatten_with_path(shapes)
    out = []
    for j, (path, leaf) in enumerate(flat):
        keys = [k.key for k in path if hasattr(k, "key")]
        a = np.full(leaf.shape, 1000.0 * j, np.float32)
        if ("layers" in keys or "shared" in keys) and leaf.ndim:
            a += np.arange(leaf.shape[0], dtype=np.float32).reshape(
                (-1,) + (1,) * (leaf.ndim - 1))
        out.append(a)
    return jax.tree_util.tree_unflatten(treedef, out), flat


@pytest.mark.parametrize("arch", sorted(ASSIGNED))
def test_leaf_logical_axes_match_reference(arch):
    """Every port parameter that holds a reference leaf named by a rule gets
    the reference leaf's tuple without its stacked axis."""
    jcfg = jax_reduced_config(jax_get_config(arch))
    shapes = jax.eval_shape(
        lambda: jax_build_model(jcfg).init(jax.random.PRNGKey(0)))
    logical = jax_sharding.param_logical_tree(shapes)
    flat_l = jax.tree_util.tree_leaves(
        logical, is_leaf=lambda x: isinstance(x, tuple))
    marked, flat = _marked(shapes)
    port = params_from_numpy(jax.tree_util.tree_map(np.asarray, marked),
                             reduced_config(get_config(arch)), "cpu",
                             dtype=torch.float32)
    ruled = (set(jax_sharding._RULES_3D) | set(jax_sharding._RULES_2D)
             | set(jax_sharding._RULES_1D))
    got = sharding.param_logical_tree(port)
    held = 0
    for name, p in port.named_parameters():
        j = int(p.reshape(-1)[0]) // 1000
        ref_name = [k.key for k in flat[j][0] if hasattr(k, "key")][-1]
        if ref_name not in ruled:
            continue
        want = flat_l[j][len(flat_l[j]) - p.ndim:]
        assert got[name] == want, (name, ref_name, got[name], flat_l[j])
        held += 1
    assert held > 0


# ---------------------------- compression ----------------------------

@given(st.integers(0, 1000), st.integers(10, 2000))
@settings(max_examples=25, deadline=None)
def test_quantize_roundtrip_error_bound(seed, n):
    rng = np.random.default_rng(seed)
    x = torch.tensor(rng.normal(0, 3, n).astype(np.float32))
    q, s = quantize_int8(x)
    y = dequantize_int8(q, s, x.shape, x.dtype)
    blockmax = float(x.abs().max())
    assert float((x - y).abs().max()) <= blockmax / 127.0 + 1e-6


def test_error_feedback_removes_bias():
    """With residual carrying, the mean compressed gradient converges to
    the true mean (compression bias vanishes)."""
    rng = np.random.default_rng(1)
    g_true = torch.tensor(rng.normal(0, 1, 512).astype(np.float32))
    resid = None
    acc = torch.zeros_like(g_true)
    n = 40
    for _ in range(n):
        qtree, resid = compress_tree({"g": g_true}, resid)
        acc = acc + decompress_tree(qtree, {"g": g_true})["g"]
    np.testing.assert_allclose((acc / n).numpy(), g_true.numpy(), atol=2e-3)


def _bits(x):
    if isinstance(x, torch.Tensor):
        return (x.view(torch.int16) if x.dtype == torch.bfloat16 else x).numpy()
    x = np.asarray(x)
    return x.view(np.int16) if x.dtype == jnp.bfloat16 else x


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n", [256, 1000, 4096 + 7])
def test_quantize_bitwise_equals_reference(dtype, n):
    rng = np.random.default_rng(n)
    a = (rng.normal(0, 3, n) * rng.lognormal(0, 2, n)).astype(np.float32)
    a[:7] = 0.0                                     # an all-but-zero block
    jx = jnp.asarray(a).astype(dtype)
    tx = torch.tensor(a).to(getattr(torch, dtype))
    jq, js = jax_comp.quantize_int8(jx)
    tq, ts = quantize_int8(tx)
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    assert ts.dtype == tx.dtype
    np.testing.assert_array_equal(_bits(ts), _bits(js))
    np.testing.assert_array_equal(
        _bits(dequantize_int8(tq, ts, tx.shape, tx.dtype)),
        _bits(jax_comp.dequantize_int8(jq, js, jx.shape, jx.dtype)))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_compress_tree_bitwise_equals_reference(dtype):
    """Three rounds of error feedback on a dict of gradients (one needs
    padding): q, scales and residuals bit for bit."""
    rng = np.random.default_rng(7)
    shapes = {"a": (33, 17), "b": (256,), "c": (4, 5, 6)}
    j_resid = t_resid = None
    for _ in range(3):
        g = {k: rng.normal(0, 1, s).astype(np.float32) for k, s in shapes.items()}
        jg = {k: jnp.asarray(v).astype(dtype) for k, v in g.items()}
        tg = {k: torch.tensor(v).to(getattr(torch, dtype)) for k, v in g.items()}
        jq, j_resid = jax_comp.compress_tree(jg, j_resid)
        tq, t_resid = compress_tree(tg, t_resid)
        for k in shapes:
            np.testing.assert_array_equal(tq[k][0].numpy(), np.asarray(jq[k][0]))
            np.testing.assert_array_equal(_bits(tq[k][1]), _bits(jq[k][1]))
            np.testing.assert_array_equal(t_resid[k].numpy(),
                                          np.asarray(j_resid[k]))
        jd = jax_comp.decompress_tree(jq, jg)
        td = decompress_tree(tq, tg)
        for k in shapes:
            np.testing.assert_array_equal(_bits(td[k]), _bits(jd[k]))


# ---------------------------- pipeline parallelism ----------------------

S, M, D = 4, 8, 16

REFERENCE_PIPELINE = textwrap.dedent("""
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import jax, jax.numpy as jnp, numpy as np
    from repro.distributed.pipeline import make_pp_mesh, pipeline_forward

    S, M, D = 4, 8, 16
    mesh = make_pp_mesh(S, 1)
    rng = np.random.default_rng(0)
    w = jnp.asarray(rng.normal(0, 0.5, (S, D, D)).astype(np.float32))
    x = jnp.asarray(rng.normal(0, 1, (M, 2, D)).astype(np.float32))
    fn = pipeline_forward(lambda p, x: jnp.tanh(x @ p), S, M, mesh)
    with mesh:
        y = fn(w, x)
    np.save(sys.argv[1], np.asarray(y))
""")


def _inputs():
    rng = np.random.default_rng(0)
    w = rng.normal(0, 0.5, (S, D, D)).astype(np.float32)
    x = rng.normal(0, 1, (M, 2, D)).astype(np.float32)
    return w, x


def _weights(y):
    return torch.sin(torch.arange(y.numel(), dtype=torch.float32)).reshape(y.shape)


def _pipeline_rank(rank):
    import torch.distributed as dist
    from repro_torch.distributed.pipeline import make_pp_mesh, pipeline_forward
    mesh = make_pp_mesh(S, 1, device_type="cpu")
    w, x = (torch.tensor(a).requires_grad_() for a in _inputs())
    y = pipeline_forward(lambda p, x: torch.tanh(x @ p), S, M, mesh)(w, x)
    gw, gx = torch.autograd.grad((y * _weights(y)).sum(), [w, x],
                                 allow_unused=True)
    gx = torch.zeros_like(x) if gx is None else gx   # stage 0 reads x
    dist.all_reduce(gx)
    return y.detach().numpy(), gw[rank].numpy(), gx.numpy()


def test_pipeline_matches_reference_and_sequential_gradients(tmp_path):
    out = tmp_path / "y.npy"
    r = subprocess.run(
        [sys.executable, "-c", REFERENCE_PIPELINE, str(out)],
        capture_output=True, text=True, timeout=300,
        env={"PYTHONPATH": "src", "PATH": "/usr/bin:/bin",
             "JAX_PLATFORMS": os.environ.get("JAX_PLATFORMS", "cpu")})
    assert r.returncode == 0, r.stderr[-2000:]
    y_ref = np.load(out)
    ranks = run_ranks(S, _pipeline_rank)
    w, x = (torch.tensor(a).requires_grad_() for a in _inputs())
    seq = x
    for s in range(S):
        seq = torch.tanh(seq @ w[s])
    gw, gx = torch.autograd.grad((seq * _weights(seq)).sum(), [w, x])
    for rank, (y, g_stage, g_x) in enumerate(ranks):
        # the output reaches every stage
        np.testing.assert_allclose(y, y_ref, rtol=2e-5, atol=2e-5)
        np.testing.assert_allclose(y, seq.detach().numpy(), rtol=2e-5, atol=2e-5)
        np.testing.assert_allclose(g_stage, gw[rank].numpy(), rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(g_x, gx.numpy(), rtol=1e-5, atol=1e-5)
