"""Sharded training through the launcher (``--mesh``), gloo groups of CPU
processes against the one-device step.

A sharded step computes the function the one-device step computes: for
smollm-360m (tensor parallelism in ``head_dim`` mode), qwen3-moe-30b-a3b
(``head`` mode with ``kv_repeat`` 2, experts over ``model``), rwkv6-1.6b,
zamba2-1.2b and h2o-danube-1.8b (``head`` mode, ``kv_repeat`` 2, a sliding
window) at 1x2, 2x1 and 2x2, and h2o-danube at 2x2 under the ``dp``, ``hd``
and ``sp`` variants, two launcher steps give the 1x1 launcher's losses
within 1e-5 relative and its float32 masters (gathered) within 1e-4
relative Frobenius per leaf, ``tests/test_torch_train.py``'s tolerances.
The configs are ``reduced_config``'s in float32 compute: in bf16 the ranks'
partial sums of a gradient round apart from the one device's single sum
(the forward is bf16-exact, ``test_bf16_mesh_forward_is_the_one_device_forward``).

Also: one rank in a group at 1x1 (the ``DTensor`` path the card runs) is the
plain step; a 2x2 checkpoint is the 1x1 layout and restores at
1x1 bit for bit; ``ElasticContext.on_change`` from 2x2 to 4x1 and 1x4 keeps
every gathered leaf bit for bit and the next step is the 1x1 step; remat
over DTensor layers gives the gradients without it; a mesh
whose size is not the world's raises, naming both; the production mesh in a
world of 4 raises, naming 256.
"""
import json
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch
from _torch_dist import run_ranks

from repro_torch.launch import train
from repro_torch.train.checkpoint import latest_step, restore_checkpoint

ARCHS = ["smollm-360m", "qwen3-moe-30b-a3b", "rwkv6-1.6b", "zamba2-1.2b",
         "h2o-danube-1.8b"]
VARIANT_ARCH = "h2o-danube-1.8b"
ELASTIC_ARCH = "h2o-danube-1.8b"
STEPS, SEQ, BATCH = 2, 32, 8
CASES = ([(a, m, "baseline") for a in ARCHS for m in ("1x2", "2x1", "2x2")]
         + [(VARIANT_ARCH, "2x2", v) for v in ("dp", "hd", "sp")])


def _argv(arch, mesh, variant, ckpt_dir):
    return ["--arch", arch, "--reduced", "--steps", str(STEPS), "--seq",
            str(SEQ), "--batch", str(BATCH), "--mesh", mesh, "--variant",
            variant, "--ckpt-dir", str(ckpt_dir)]


def _float32_compute():
    """The launcher's ``--reduced`` configs in float32 compute."""
    reduced = train.reduced_config
    train.reduced_config = lambda cfg: reduced(cfg).replace(dtype="float32")
    return reduced


def _gathered(tree):
    """Whole numpy arrays of a dict of tensors (a collective for DTensors)."""
    return {k: (v.full_tensor() if hasattr(v, "full_tensor") else v)
            .detach().numpy().copy() for k, v in tree.items()}


def _run(rank, arch, mesh, variant, tmp):
    out = train.main(_argv(arch, mesh, variant, f"{tmp}/{arch}-{mesh}-{variant}"),
                     device="cpu")
    params = _gathered(out["params"])
    return out["losses"], params if rank == 0 else None


def _group(rank, world, tmp):
    """Every case of this world size, then the checks of a wrong size."""
    _float32_compute()
    res = {}
    for arch, mesh, variant in CASES:
        d, m = (int(x) for x in mesh.split("x"))
        if d * m == world:
            res[(arch, mesh, variant)] = _run(rank, arch, mesh, variant, tmp)
    errors = {}
    try:
        train.main(_argv("smollm-360m", "2x2" if world == 2 else "2x4",
                         "baseline", f"{tmp}/wrong"), device="cpu")
    except RuntimeError as e:
        errors["world"] = str(e)
    if world == 4:
        from repro_torch.launch.mesh import make_production_mesh
        try:
            make_production_mesh(device_type="cpu")
        except RuntimeError as e:
            errors["production"] = str(e)
        res["elastic"] = _elastic(rank, tmp)
        res["remat"] = _remat(rank)
    return res, errors


def _remat(rank):
    """Loss and gradients at 2x2 with each layer rematerialised (both
    policies) against without: the worst relative gap."""
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.configs import get_config, reduced_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.distributed.axes import axis_env
    from repro_torch.distributed.sharding import (batch_pspecs, make_plan,
                                                  param_pspecs)
    from repro_torch.models import build_model
    from repro_torch.train.data import DataConfig, SyntheticLM
    from repro_torch.train.trainer import (batch_to, make_value_and_grad,
                                           param_dict)
    cfg = reduced_config(get_config("smollm-360m")).replace(dtype="float32")
    mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
    plan = make_plan(cfg, mesh, "train", ShapeConfig("cli", SEQ, BATCH, "train"))
    params = param_dict(build_model(plan.cfg).init(0, device="cpu",
                                                   dtype=torch.float32))
    params = plan.distribute(params, param_pspecs(params, plan.mapping))
    b = batch_to(SyntheticLM(DataConfig(vocab_size=cfg.vocab_size, seq_len=SEQ,
                                        global_batch=BATCH, seed=0)).batch(0), "cpu")
    b = plan.distribute(b, batch_pspecs(plan.cfg, plan.mapping, b))
    out = {}
    for remat, policy in ((False, "minimal"), (True, "minimal"), (True, "dots")):
        model = build_model(plan.cfg, remat=remat, remat_policy=policy)
        with axis_env(mesh, plan.mapping):
            loss, _, grads = make_value_and_grad(model)(params, b)
        out[(remat, policy)] = float(loss), _gathered(grads)
    base_loss, base = out[(False, "minimal")]
    worst = 0.0
    for key in ((True, "minimal"), (True, "dots")):
        loss, grads = out[key]
        worst = max(worst, abs(loss - base_loss) / abs(base_loss),
                    *(_rel(grads[k], base[k]) for k in base))
    return worst


def _elastic(rank, tmp):
    """One step at 2x2, then ``on_change`` to 4x1 and (from the same 2x2
    state) to 1x4, and one more step on each."""
    from repro_torch.configs import get_config, reduced_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.distributed.elastic import ElasticContext
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.distributed.sharding import make_plan, param_pspecs
    from repro_torch.models import build_model
    from repro_torch.train.data import DataConfig, SyntheticLM
    from repro_torch.train.optimizer import AdamWConfig, adamw_init
    from repro_torch.train.trainer import make_train_step, param_dict
    cfg = reduced_config(get_config(ELASTIC_ARCH)).replace(dtype="float32")
    opt_cfg = AdamWConfig(lr=1e-3, warmup_steps=10, total_steps=100)
    ds = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size, seq_len=SEQ,
                                global_batch=BATCH, seed=0))
    shape = ShapeConfig("cli", SEQ, BATCH, "train")
    dev = torch.device("cpu")

    def step_on(plan):
        return train.sharded_step(make_train_step(build_model(plan.cfg), opt_cfg),
                                  plan, dev)
    mesh = make_test_mesh((2, 2), device_type="cpu")
    plan = make_plan(cfg, mesh, "train", shape)
    params = param_dict(build_model(plan.cfg).init(0, device=dev,
                                                   dtype=torch.float32))
    params = plan.distribute(params, param_pspecs(params, plan.mapping))
    params, opt, m0 = step_on(plan)(params, adamw_init(params), ds.batch(0))
    before = _gathered(params), _gathered(opt["mu"]), _gathered(opt["nu"])
    out = {}
    for shape2 in ((4, 1), (1, 4)):
        ctx = ElasticContext(cfg, "train", mesh)
        new_mesh = make_test_mesh(shape2, device_type="cpu")
        p2, o2 = ctx.on_change(new_mesh, params, opt)
        after = _gathered(p2), _gathered(o2["mu"]), _gathered(o2["nu"])
        same = all(np.array_equal(a[k], b[k]) for a, b in zip(before, after)
                   for k in a)
        p3, _, m1 = step_on(ctx.plan)(p2, o2, ds.batch(1))
        p3 = _gathered(p3)     # every rank joins the gathers
        out[shape2] = (same, ctx.plan.cfg.attention.kv_repeat,
                       [float(m0["loss"]), float(m1["loss"])],
                       p3 if rank == 0 else None)
    return out


def _one_rank(rank, tmp):
    """--mesh 1x1 in a group of one (the DTensor path), then, the group
    gone, without one, in the same process: losses and masters."""
    import torch.distributed as dist
    _float32_compute()
    archs = ("smollm-360m", "qwen3-moe-30b-a3b")
    mesh = {}
    for arch in archs:
        r = train.main(_argv(arch, "1x1", "baseline", f"{tmp}/{arch}-group"),
                       device="cpu")
        mesh[arch] = (r["losses"], _gathered(r["params"]))
    dist.destroy_process_group()
    out = {}
    for arch in archs:
        r = train.main(_argv(arch, "1x1", "baseline", f"{tmp}/{arch}-plain"),
                       device="cpu")
        out[arch] = (mesh[arch], (r["losses"], _gathered(r["params"])))
    return out


def _rel(a, b, floor: float = 0.0) -> float:
    a, b = a.astype(np.float64), b.astype(np.float64)
    nb = max(np.linalg.norm(b), floor)
    return float(np.linalg.norm(a - b) / (nb if nb > 0 else 1.0))


def _hold(losses, params, want_losses, want_params):
    """Losses within 1e-5 relative; masters within 1e-4 relative Frobenius
    per leaf, a leaf near 0 (a bias whose gradient is rounding noise)
    relative to 1e-3 of the largest leaf, as ``test_torch_train``'s."""
    np.testing.assert_allclose(losses, want_losses, rtol=1e-5)
    assert params.keys() == want_params.keys()
    floor = 1e-3 * max(float(np.linalg.norm(w)) for w in want_params.values())
    for k, v in params.items():
        assert _rel(v, want_params[k], floor) <= 1e-4, k


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("mesh")
    reduced = _float32_compute()
    try:
        with ThreadPoolExecutor(2) as pool:   # both groups at once
            futures = {n: pool.submit(run_ranks, n, _group, n, str(tmp),
                                      timeout=240) for n in (2, 4)}
            groups = {n: f.result() for n, f in futures.items()}
        one = {}
        for arch, variant in sorted({(a, v) for a, _, v in CASES}):
            r = train.main(_argv(arch, "1x1", variant, tmp / f"one-{arch}-{variant}"),
                           device="cpu")
            one[(arch, variant)] = (r["losses"], _gathered(r["params"]))
    finally:
        train.reduced_config = reduced
    return {"groups": groups, "one": one, "tmp": tmp}


@pytest.mark.parametrize("arch,mesh,variant", CASES,
                         ids=["-".join(c) for c in CASES])
def test_mesh_step_is_the_one_device_step(runs, arch, mesh, variant):
    d, m = (int(x) for x in mesh.split("x"))
    results, _ = runs["groups"][d * m][0]
    losses, params = results[(arch, mesh, variant)]
    _hold(losses, params, *runs["one"][(arch, variant)])
    for rank_results, _ in runs["groups"][d * m][1:]:   # the loss is global
        assert rank_results[(arch, mesh, variant)][0] == losses


def test_checkpoint_at_2x2_is_the_1x1_layout(runs):
    tmp = runs["tmp"]
    sharded = tmp / "smollm-360m-2x2-baseline"
    single = tmp / "one-smollm-360m-baseline"
    assert latest_step(str(sharded)) == latest_step(str(single)) == STEPS
    name = f"step_{STEPS:08d}/manifest.json"
    a = json.loads((sharded / name).read_text())
    b = json.loads((single / name).read_text())
    assert a == b
    # restored at 1x1 into plain tensors: the 2x2 run's gathered masters
    like = {k: torch.from_numpy(v) for k, v in
            runs["one"][("smollm-360m", "baseline")][1].items()}
    (restored, opt), _ = restore_checkpoint(
        str(sharded), (like, {"mu": like, "nu": like,
                              "step": torch.zeros((), dtype=torch.int32)}))
    results, _ = runs["groups"][4][0]
    masters = results[("smollm-360m", "2x2", "baseline")][1]
    for k, v in restored.items():
        assert np.array_equal(v.numpy(), masters[k]), k
    assert int(opt["step"]) == STEPS


def test_elastic_reshard_keeps_every_leaf(runs):
    results, _ = runs["groups"][4][0]
    want_losses, want = runs["one"][(ELASTIC_ARCH, "baseline")]
    for shape2, kv_repeat in (((4, 1), 1), ((1, 4), 4)):
        same, rep, losses, params = results["elastic"][shape2]
        assert same, shape2
        assert rep == kv_repeat      # the new plan: h2o-danube's KV 1 at tp 4
        _hold(losses, params, want_losses, want)


def test_remat_under_a_mesh_is_no_remat(runs):
    """Layers rematerialised (``minimal`` and ``dots``) over DTensors at
    2x2, smollm: loss and gradients within 1e-6 of no remat."""
    results, _ = runs["groups"][4][0]
    assert results["remat"] <= 1e-6


def test_mesh_of_another_size_than_the_world_raises(runs):
    for n, wanted in ((2, "needs 4 ranks; this world has 2"),
                      (4, "needs 8 ranks; this world has 4")):
        for _, errors in runs["groups"][n]:
            assert wanted in errors["world"]


def test_production_mesh_needs_256_ranks(runs):
    for _, errors in runs["groups"][4]:
        assert "needs 256 ranks; this world has 4" in errors["production"]


def test_one_rank_group_is_the_plain_step(tmp_path):
    """Within 1e-6: bit for bit on torch 2.13's CPU and on the card
    (``chip_smoke.py`` phase 19a); torch 2.11's CPU rounded one step's
    loss by an ulp."""
    (out,) = run_ranks(1, _one_rank, str(tmp_path), timeout=120)
    for arch, ((ml, mp), (pl, pp)) in out.items():
        np.testing.assert_allclose(ml, pl, rtol=1e-6)
        for k in pp:
            assert _rel(mp[k], pp[k]) <= 1e-6, (arch, k)


def _bf16_forward(rank, tmp):
    """The first step's loss (the forward at the initial masters) in bf16
    compute, at 2x2, for two archs."""
    return {arch: train.main(_argv(arch, "2x2", "baseline", f"{tmp}/{arch}"),
                             device="cpu")["losses"][0]
            for arch in ("smollm-360m", "qwen3-moe-30b-a3b")}


def test_bf16_mesh_forward_is_the_one_device_forward(tmp_path):
    """In bf16 compute the forward is the one device's: a row-parallel
    product gathers its operands rather than summing bf16 partials
    (``distributed.axes.contract_whole``)."""
    got = run_ranks(4, _bf16_forward, str(tmp_path / "mesh"), timeout=120)[0]
    for arch, loss in got.items():
        want = train.main(_argv(arch, "1x1", "baseline", tmp_path / arch),
                          device="cpu")["losses"][0]
        np.testing.assert_allclose(loss, want, rtol=1e-6)
