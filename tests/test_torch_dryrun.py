"""The dry-run and roofline stack, JAX reference against the PyTorch port,
on the CPU.

(a) ``launch.specs`` and ``analysis.roofline`` against the reference on
every one of the 40 (arch x shape) cells and both production meshes: input
specs (shapes, dtypes), parameter and cache shapes (the reference's
``eval_shape`` of ``init`` / ``init_cache``, leaf to leaf through
``models.convert``'s names), ``auto_grad_accum``, the MODEL FLOPs and ideal
bytes, ``analyze_cell`` and ``markdown_table`` at the reference's TPU v5e
rates, all exactly. The planning functions read a mesh's axis sizes only,
so both packages get a stand-in with a ``shape`` dict.
(c) ``analysis.program``'s counter on reduced configs in fake process
groups: a D x 1 mesh's per-device FLOPs are 1 x 1's / D, a forward equals
``FlopCounterMode``'s total, a 1 x 1 mesh sends nothing, a loop's
collectives and FLOPs count every iteration, and layers add collectives
one layer's worth at a time (the counterpart of the reference's
``test_hlo_loop_aware_accounting``).
(d) ``python -m repro_torch.launch.dryrun`` on the CPU, the counterpart of
the reference's ``test_dryrun_cell_subprocess``.
"""
import functools
import json
import re
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch
from torch.distributed.tensor import Replicate, Shard, distribute_tensor
from torch.utils.flop_counter import FlopCounterMode

from repro.analysis import roofline as jax_roofline
from repro.configs import all_cells as jax_all_cells
from repro.configs import get_config as jax_get_config
from repro.configs import get_shape as jax_get_shape
from repro.configs import reduced_config as jax_reduced_config
from repro.core.power import TPU_V5E as JAX_TPU_V5E
from repro.distributed import sharding as jax_sharding
from repro.launch import specs as jax_specs
from repro.models import build_model as jax_build_model
from repro_torch.analysis import roofline
from repro_torch.analysis.program import (TraceMode, collective_bytes,
                                          program_stats, trace_program)
from repro_torch.configs import all_cells, get_config, get_shape, reduced_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.core.power import TPU_V5E
from repro_torch.distributed import sharding
from repro_torch.launch import specs
from repro_torch.launch.dryrun import fake_world, trace_cell
from repro_torch.launch.mesh import make_test_mesh
from repro_torch.models import build_model
from repro_torch.models.convert import params_from_numpy

ROOT = Path(__file__).resolve().parents[1]
MESHES = {"16x16": {"data": 16, "model": 16},
          "2x16x16": {"pod": 2, "data": 16, "model": 16}}
CELLS = [(a, s) for a, s, _, _ in all_cells()]


# ---------------------------- (a) specs ----------------------------

def _dtype_name(d):
    return str(d).removeprefix("torch.")


@functools.lru_cache(maxsize=None)
def _port_to_reference_leaf(arch):
    """{port name with layer indices as '*': (reference key path, stacked)}
    from the reduced config, whose tree has the full one's structure: every
    element of reference leaf j is marked j (+ its stacked index)."""
    jcfg = jax_reduced_config(jax_get_config(arch))
    shapes = jax.eval_shape(lambda: jax_build_model(jcfg).init(
        jax.random.PRNGKey(0)))
    flat, treedef = jax.tree_util.tree_flatten_with_path(shapes)
    marked = jax.tree_util.tree_unflatten(treedef, [
        np.full(leaf.shape, 1000.0 * j, np.float32) for j, (_, leaf) in
        enumerate(flat)])
    port = params_from_numpy(marked, reduced_config(get_config(arch)), "cpu",
                             dtype=torch.float32)
    out = {}
    for name, p in port.named_parameters():
        j = int(p.reshape(-1)[0]) // 1000
        keys = tuple(k.key for k in flat[j][0] if hasattr(k, "key"))
        out[re.sub(r"\.\d+\.", ".*.", name)] = (keys, re.search(r"\.\d+\.", name)
                                               is not None)
    assert len(set(v[0] for v in out.values())) == len(flat)
    return out


@functools.lru_cache(maxsize=None)
def _reference_param_shapes(arch):
    shapes = jax.eval_shape(lambda: jax_build_model(jax_get_config(arch)).init(
        jax.random.PRNGKey(0)))
    return {tuple(k.key for k in path if hasattr(k, "key")): tuple(leaf.shape)
            for path, leaf in jax.tree_util.tree_flatten_with_path(shapes)[0]}


@pytest.mark.parametrize("arch", sorted({a for a, _ in CELLS}))
def test_abstract_params_match_reference(arch):
    """Every port parameter has the reference leaf's shape (without the
    stacked layer axis), both dtypes of a cell, every reference leaf held."""
    want = _reference_param_shapes(arch)
    names = _port_to_reference_leaf(arch)
    model = build_model(get_config(arch))
    for dtype in (torch.float32, torch.bfloat16):
        got = specs.abstract_params(model, dtype)
        held = set()
        for name, t in got.items():
            keys, stacked = names[re.sub(r"\.\d+\.", ".*.", name)]
            assert t.device.type == "meta"
            assert tuple(t.shape) == want[keys][1 if stacked else 0:], name
            held.add(keys)
        assert held == set(want)
        assert any(t.dtype == dtype for t in got.values())


def _fake_mesh(mesh):
    return SimpleNamespace(shape=dict(MESHES[mesh]))


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch,shape", CELLS)
def test_cell_specs_match_reference(arch, shape, mesh):
    """Input specs, the decode cache's shapes and auto_grad_accum of the
    cell's plan on the production mesh."""
    assert CELLS == [(a, s) for a, s, _, _ in jax_all_cells()]
    cfg, jcfg = get_config(arch), jax_get_config(arch)
    sh, jsh = get_shape(shape), jax_get_shape(shape)
    fake = _fake_mesh(mesh)
    kind = "train" if sh.kind == "train" else sh.kind
    jplan = jax_sharding.make_plan(jcfg, fake, kind, jsh)
    plan = sharding.make_plan(cfg, fake, kind, sh, hbm_per_chip=16e9)
    want = jax_specs.input_specs(jplan.cfg, jsh)
    got = specs.input_specs(plan.cfg, sh)
    assert {k: (tuple(v.shape), _dtype_name(v.dtype)) for k, v in got.items()} \
        == {k: (tuple(v.shape), str(v.dtype)) for k, v in want.items()}
    if sh.kind == "decode" and cfg.supports_decode():
        jc = jax_specs.abstract_cache(jax_build_model(jplan.cfg),
                                      jsh.global_batch, jsh.seq_len)
        tc = specs.abstract_cache(build_model(plan.cfg), sh.global_batch,
                                  sh.seq_len)
        assert {k: (tuple(v.shape), _dtype_name(v.dtype)) for k, v in tc.items()} \
            == {k: (tuple(v.shape), str(v.dtype)) for k, v in jc.items()}
    baxes = plan.mapping.get("batch") or ("data",)
    seq_ax = plan.mapping.get("seq")
    seq_shards = MESHES[mesh].get(seq_ax, 1) if seq_ax else 1
    assert specs.auto_grad_accum(plan.cfg, sh, fake, batch_axes=baxes,
                                 seq_shards=seq_shards) == \
        jax_specs.auto_grad_accum(jplan.cfg, jsh, fake, batch_axes=baxes,
                                  seq_shards=seq_shards)


# ---------------------------- (a) roofline ----------------------------

def _record(arch, shape, mesh, i):
    """A dry-run record with made-up counts (cell i)."""
    return {"arch": arch, "shape": shape, "mesh": mesh, "runnable": True,
            "loop_aware": {"dot_flops": 3.7e12 * (i + 1), "hbm_bytes": 1.9e10 + i,
                           "dot_count": 100.0 + i},
            "collectives": {"link_bytes": 4.1e9 * (i % 7 + 1)},
            "memory": {"temp_bytes": 2.5e9 * (i % 5), "argument_bytes": 1.1e9 * i},
            "n_devices": 512}


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_roofline_matches_reference(mesh):
    """MODEL FLOPs, ideal bytes, analyze_cell (TPU v5e's rates passed in) and
    the table, exactly, on every cell."""
    chips = 512 if mesh == "2x16x16" else 256
    cells, jcells = [], []
    for i, (arch, shape) in enumerate(CELLS):
        assert roofline.model_flops_per_device(arch, shape, chips) == \
            jax_roofline.model_flops_per_device(arch, shape, chips)
        assert roofline.ideal_bytes_per_device(arch, shape, chips) == \
            jax_roofline.ideal_bytes_per_device(arch, shape, chips)
        rec = _record(arch, shape, mesh, i)
        got = roofline.analyze_cell(rec, TPU_V5E)
        want = jax_roofline.analyze_cell(rec)
        want["temp_bytes_est"] = want.pop("temp_bytes_tpu_est")
        assert got == want
        cells.append(got)
        jcells.append(want)
    skipped = {"arch": "hubert-xlarge", "shape": "decode_32k", "mesh": mesh,
               "skipped": True, "reason": "encoder-only: no decode step"}
    assert roofline.markdown_table(cells + [skipped], TPU_V5E) == \
        jax_roofline.markdown_table(jcells + [skipped])
    assert TPU_V5E.peak_flops == JAX_TPU_V5E.peak_flops


def test_roofline_prices_the_h100_by_default(monkeypatch, tmp_path):
    rec = _record("smollm-360m", "train_4k", "16x16", 0)
    cell = roofline.analyze_cell(rec)
    assert cell["t_compute_s"] == rec["loop_aware"]["dot_flops"] / 989e12
    assert cell["t_memory_s"] == rec["loop_aware"]["hbm_bytes"] / 3.35e12
    assert cell["t_collective_s"] == rec["collectives"]["link_bytes"] / 450e9
    assert "| fits 80G |" in roofline.markdown_table([cell]).splitlines()[0]
    (tmp_path / "16x16").mkdir()
    (tmp_path / "16x16" / "a.json").write_text(json.dumps(rec))
    (tmp_path / "16x16" / "b.json").write_text(json.dumps(
        {"arch": "hubert-xlarge", "shape": "long_500k", "runnable": False,
         "reason": "encoder-only: no decode step"}))
    monkeypatch.setattr(roofline, "RESULTS", tmp_path)
    assert roofline.load_all("16x16") == [cell, {
        "arch": "hubert-xlarge", "shape": "long_500k", "mesh": "16x16",
        "skipped": True, "reason": "encoder-only: no decode step"}]


# ---------------------------- (c) the counter ----------------------------

TINY = {"train": ShapeConfig("t", 64, 8, "train"),
        "prefill": ShapeConfig("p", 64, 8, "prefill")}


def _traced(arch, kind, mesh_shape, **cut):
    cfg = reduced_config(get_config(arch)).replace(**cut)
    with fake_world(int(np.prod(mesh_shape))):
        mesh = make_test_mesh(mesh_shape, device_type="cpu")
        return trace_cell(cfg, TINY[kind], mesh, device="cpu")


@pytest.mark.parametrize("arch", ["smollm-360m", "qwen3-moe-30b-a3b"])
def test_data_parallel_flops_divide_by_the_mesh(arch):
    one = _traced(arch, "train", (1, 1))
    four = _traced(arch, "train", (4, 1))
    assert four["loop_aware"]["dot_flops"] == pytest.approx(
        one["loop_aware"]["dot_flops"] / 4, rel=1e-2)
    assert one["collectives"]["total"] == 0 and one["collectives"]["count"] == 0
    assert four["collectives"]["total"] > 0
    assert four["memory"]["argument_bytes"] < one["memory"]["argument_bytes"]


def test_forward_flops_equal_flop_counter_mode():
    from repro_torch.launch.specs import build_cell
    cfg = reduced_config(get_config("stablelm-1.6b"))
    with fake_world(1):
        mesh = make_test_mesh((1, 1), device_type="cpu")
        mode = TraceMode()
        _, fn, args, _, _ = build_cell(cfg, TINY["prefill"], mesh,
                                       fake_mode=mode, device="cpu")
        _, trace = trace_program(fn, *args, fake_mode=mode)
        with mode, FlopCounterMode(display=False) as fc:
            fn(*args)
    assert trace.dot_flops == fc.get_total_flops() > 0
    assert collective_bytes(trace)["total"] == 0


def test_loop_counts_every_iteration():
    """The counterpart of ``test_hlo_loop_aware_accounting``: ten iterations
    of a 128 x 128 float32 product contracted over a 2-rank axis and its
    all-reduce; each rank's product is half of the whole."""
    with fake_world(2):
        mesh = make_test_mesh((1, 2), device_type="cpu")
        mode = TraceMode()
        with mode:
            a, b = (distribute_tensor(torch.empty(128, 128), mesh,
                                      [Replicate(), Shard(d)], src_data_rank=None)
                    for d in (1, 0))

        def loop(a, b):
            return [(a @ b).redistribute(mesh, [Replicate(), Replicate()])
                    for _ in range(10)]

        _, trace = trace_program(loop, a, b, fake_mode=mode)
    coll = collective_bytes(trace)
    assert coll["all-reduce"] == 128 * 128 * 4 * 10 == coll["total"]
    assert coll["count"] == 10 and coll["link_bytes"] == 2 * coll["all-reduce"]
    stats = program_stats(trace)
    assert stats["dot_flops"] == 2 * 128 * 64 * 128 * 10
    assert stats["dot_count"] == 10


def test_layers_add_collectives_one_layer_at_a_time():
    """On a 2x4 mesh each layer adds the same collectives: L = 4 adds twice
    what L = 2 adds over L = 1."""
    got = {L: _traced("stablelm-1.6b", "prefill", (2, 4), n_layers=L)
           for L in (1, 2, 4)}
    for key in ("all-gather", "total", "count", "link_bytes"):
        c = {L: r["collectives"][key] for L, r in got.items()}
        assert c[2] > c[1]
        assert c[4] - c[2] == 2 * (c[2] - c[1]), key
    f = {L: r["loop_aware"]["dot_flops"] for L, r in got.items()}
    assert f[4] - f[2] == 2 * (f[2] - f[1])


def test_axis_env_reaches_autograd_threads():
    """Autograd runs a CUDA backward, and remat's recomputation in it, on a
    device thread: the axis env of the forward must be the one it sees."""
    import threading

    from repro_torch.distributed import axes
    seen = []
    mesh = SimpleNamespace(mesh_dim_names=("data", "model"), shape=(1, 1))
    with axes.axis_env(mesh, {"batch": "data"}):
        t = threading.Thread(target=lambda: seen.append(axes._current()))
        t.start()
        t.join(timeout=10)
    assert not t.is_alive() and seen[0]["map"] == {"batch": "data"}
    assert axes._current() is None


# ---------------------------- (d) the entry point ----------------------------

def test_dryrun_cell_subprocess():
    """The entry point at full width on a fake 16x16 world, CPU tensors; the
    record it writes is put back as it was."""
    out = ROOT / "results/torch/dryrun/16x16/stablelm-1.6b__decode_32k.json"
    before = out.read_bytes() if out.exists() else None
    try:
        r = subprocess.run(
            [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
             "stablelm-1.6b", "--shape", "decode_32k", "--torch-device", "cpu",
             "--quiet"], capture_output=True, text=True, timeout=300,
            cwd=ROOT, env={"PYTHONPATH": str(ROOT / "src"),
                           "PATH": "/usr/bin:/bin"})
        assert r.returncode == 0, r.stderr[-2000:]
        assert json.loads(out.read_text())["device"] == "cpu"
    finally:
        if before is None:
            out.unlink(missing_ok=True)
        else:
            out.write_bytes(before)
    assert '"trace_s"' in r.stdout
    rec = json.loads(r.stdout)
    assert rec["n_devices"] == 256 and rec["loop_aware"]["dot_flops"] > 0
    assert rec["collectives"]["total"] > 0


def test_dryrun_refuses_the_kernels():
    cfg = reduced_config(get_config("stablelm-1.6b"))
    with fake_world(1), pytest.raises(ValueError, match="no fake form"):
        trace_cell(cfg, TINY["prefill"], make_test_mesh((1, 1), device_type="cpu"),
                   attn_impl="kernel", device="cpu")
