"""Package rules of the PyTorch port: it stands alone (no JAX, no reference
package), its entry points never drop to the CPU on their own, and its Eq. 1
agrees with the reference's."""
import ast
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro.core.power import DEVICES as JAX_DEVICES
from repro.core.power import power as jax_power
from repro_torch.core.power import DEVICES, power

ROOT = pathlib.Path(__file__).resolve().parents[1]
PKG = ROOT / "src" / "repro_torch"


def _modules():
    return sorted(".".join(p.relative_to(ROOT / "src").with_suffix("").parts)
                  .removesuffix(".__init__") for p in PKG.rglob("*.py"))


def test_every_module_imports_without_jax_or_reference():
    code = ("import sys, importlib\n"
            "sys.modules['jax'] = None\n"
            "sys.modules['repro'] = None\n"
            f"for m in {_modules()!r}:\n"
            "    importlib.import_module(m)\n"
            "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120,
                         env={"PYTHONPATH": str(ROOT / "src"),
                              "PATH": "/usr/bin:/bin"})
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def _imported_roots(path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            yield node.module


@pytest.mark.parametrize("path", sorted(PKG.rglob("*.py")) + [
    ROOT / "chip_smoke.py", ROOT / "chip_ab.py", ROOT / "chip_sweeps.py",
    ROOT / "chip_profiler_probe.py"],
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_source_imports_neither_jax_nor_reference(path):
    bad = [m for m in _imported_roots(path)
           if m.split(".")[0] in ("jax", "jaxlib", "repro")]
    assert not bad, f"{path} imports {bad}"


def test_entry_points_raise_without_a_card(monkeypatch, tmp_path):
    from repro_torch.configs import get_config, reduced_config
    from repro_torch.launch.serve import main
    from repro_torch.models import build_model
    from repro_torch.serve.engine import ServingEngine
    from repro_torch.sweep import worker
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    model = build_model(reduced_config(get_config("llama3-8b")))
    params = model.init(0, device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ServingEngine(model, params)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["--arch", "llama3-8b", "--requests", "1"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        model.init(0)
    # the remote sweep worker: before it registers or claims anything
    with pytest.raises(RuntimeError, match="no CUDA device"):
        worker.main([str(tmp_path / "q"), "--once"])
    assert not (tmp_path / "q").exists()


@pytest.mark.parametrize("name", ["h100", "a100", "a40", "tpu-v5e"])
def test_power_matches_reference(name):
    mfu = np.concatenate([np.linspace(-0.1, 1.2, 997), [0.0, 0.45, 1e-7]])
    want = np.asarray(jax_power(mfu, JAX_DEVICES[name]))
    got = power(mfu, DEVICES[name]).numpy()
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=5e-6, atol=0)


def _simulated_path_calls():
    """Each public function of the simulated path that computes with torch,
    called with its ``torch_device`` left at ``None`` (the card)."""
    import types

    from repro_torch import core, fleet, sim
    from repro_torch.configs.paper_models import LLAMA3_8B
    trace = types.SimpleNamespace(start_s=np.zeros(2), dur_s=np.ones(2),
                                  mfu=np.full(2, 0.3))
    ci = core.datasets.ci_trace_signal("caiso", 1.0)
    em = sim.ExecutionModel(LLAMA3_8B, core.DEVICES["a100"])
    res = sim.SimResult(stages=sim.StageTraceBuilder().build(), requests=[],
                        cfg=sim.PAPER_DEFAULT)
    fleet_cfg = fleet.FleetConfig(model=LLAMA3_8B, sites=(
        fleet.SiteConfig(name="a"), fleet.SiteConfig(name="b")),
        workload=sim.WorkloadConfig(n_requests=4))
    return {
        "PowerModel.power": lambda: core.PowerModel("a100").power([0.1]),
        "PowerModel.energy_wh": lambda: core.PowerModel("h100").energy_wh([0.1], [1.0]),
        "energy_report": lambda: sim.energy_report(res),
        "stage_attributed_carbon": lambda: core.stage_attributed_carbon(
            trace, core.PowerModel("a100"), 1, 1.2, ci),
        "trace_to_load_signal": lambda: core.trace_to_load_signal(
            trace, core.PowerModel("a100")),
        "microgrid.simulate": lambda: core.simulate(
            np.ones(3), np.ones(3), np.ones(3), core.MicrogridConfig()),
        "run_cosim": lambda: core.run_cosim(ci, ci, ci),
        "run_fleet_simulation": lambda: fleet.run_fleet_simulation(fleet_cfg),
        "stage_cost_batch(torch)": lambda: em.stage_cost_batch(
            sim.StageBatch(*np.ones((4, 2))), backend="torch"),
    }


SIMULATED_PATH = ["PowerModel.power", "PowerModel.energy_wh", "energy_report",
                  "stage_attributed_carbon", "trace_to_load_signal",
                  "microgrid.simulate", "run_cosim", "run_fleet_simulation",
                  "stage_cost_batch(torch)"]


@pytest.mark.parametrize("name", SIMULATED_PATH)
def test_simulated_path_raises_without_a_card(monkeypatch, name):
    """The simulated path's torch work runs on the card unless the caller
    passes ``torch_device="cpu"``; without a card it raises, never falls
    back to the host. ``run_simulation`` itself is host code."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    calls = _simulated_path_calls()
    assert sorted(calls) == sorted(SIMULATED_PATH)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        calls[name]()


def test_module_list_covers_the_sweep_engine_and_obs():
    """The no-JAX checks above walk every module of the port, the sweep
    engine, ``obs``, the day simulation, the microgrid kernel and the model
    families (MoE, Mamba2, Zamba2) included."""
    mods = _modules()
    for m in ("repro_torch.obs", "repro_torch.obs.diff",
              "repro_torch.obs.__main__", "repro_torch.obs.recorder",
              "repro_torch.sweep", "repro_torch.sweep.cli",
              "repro_torch.sweep.device", "repro_torch.sweep.runner",
              "repro_torch.sweep.remote", "repro_torch.sweep.worker",
              "repro_torch.obs.audit",
              "repro_torch.fleet.day", "repro_torch.kernels.microgrid_scan.ops",
              "repro_torch.models.moe", "repro_torch.models.mamba",
              "repro_torch.models.zamba"):
        assert m in mods


def _sweep_entry_points():
    """Each public entry point of the sweep engine, ``obs`` and the day
    simulation, called with its torch device left at ``None`` (the card)."""
    from repro_torch.fleet.day import run_fleet_day
    from repro_torch.obs import FlightRecorder
    from repro_torch.obs import __main__ as obs_cli
    from repro_torch.sweep import (SWEEPS, ResultCache, SweepRunner,
                                   execute_scenario, execute_scenario_group,
                                   run_sweep)
    from repro_torch.sweep import cli
    from repro_torch.sweep.device import execute_device_grid
    sc = SWEEPS["fig1"].build(True, n_requests=4)[0]
    day_cfg = SWEEPS["day"].build(True, n_requests=40)[0].cfg
    return {
        "SweepRunner": lambda: SweepRunner(),
        "ResultCache": lambda: ResultCache(),
        "run_sweep": lambda: run_sweep("fig1", smoke=True),
        "execute_scenario": lambda: execute_scenario(sc),
        "execute_scenario_group": lambda: execute_scenario_group([sc]),
        "execute_device_grid": lambda: execute_device_grid([sc]),
        "run_fleet_day": lambda: run_fleet_day(day_cfg),
        "FlightRecorder": lambda: FlightRecorder(),
        "sweep.cli": lambda: cli.main(["--smoke", "fig1", "--quiet"]),
        "obs record": lambda: obs_cli.main(["--quiet", "record", "fig1",
                                            "--smoke"]),
    }


SWEEP_ENTRY_POINTS = ["SweepRunner", "ResultCache", "run_sweep",
                      "execute_scenario", "execute_scenario_group",
                      "execute_device_grid", "run_fleet_day",
                      "FlightRecorder", "sweep.cli",
                      "obs record"]


@pytest.mark.parametrize("name", SWEEP_ENTRY_POINTS)
def test_sweep_engine_raises_without_a_card(monkeypatch, name, tmp_path):
    """``None`` means the card in the sweep engine, ``obs`` and the day
    simulation too: without one they raise, never fall back to the host."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.chdir(tmp_path)
    calls = _sweep_entry_points()
    assert sorted(calls) == sorted(SWEEP_ENTRY_POINTS)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        calls[name]()
