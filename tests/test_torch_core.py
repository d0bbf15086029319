"""The port's ``core/`` (Eqs. 1-5, datasets, policies, microgrid, co-sim)
against the reference, on the CPU, on the same seeded numpy inputs.

Tolerances: numpy copies (``aggregate_power``, ``to_csv``, ``datasets``,
``policies``, ``stage_mfu``, ``emissions_batch``) are bitwise. Whatever
passes through Eq. 1 (energy, carbon, load signals) is held at
``DEVICE_MODE_RTOL`` (5e-6): torch's and XLA's float32 ``pow`` may differ
by an ulp. Microgrid traces are float32 loops in both packages, held within
1e-5 of each trace's largest magnitude. Their metrics are held at 5e-6 of
the quantity they are a part of: a kWh metric of the total energy, a kg
metric of the no-solar emissions, a percentage of 100, any other of
itself. Where a step's battery decision flips on a one-ulp SoC difference,
a small difference (``offset_kg``) or a small sum (``net_emissions_kg``
under ample solar) moves by more than 5e-6 of itself, never of its whole.
"""
import dataclasses
import types

import numpy as np
import pytest
import torch

import repro.core as rc
import repro_torch.core as pc
from repro.core import datasets as rd
from repro.core import policies as rpol
from repro.core import signals as rsig
from repro_torch.core import datasets as pd
from repro_torch.core import policies as ppol
from repro_torch.core import signals as psig
from repro_torch.core.power import DEVICE_MODE_RTOL

CPU = "cpu"
RTOL = dict(rtol=DEVICE_MODE_RTOL, atol=0)


def _stages(seed, n=200):
    """Stage starts, durations and MFUs as the simulator logs them: ragged,
    overlapping a few bins, some idle gaps."""
    rng = np.random.default_rng(seed)
    dur = rng.uniform(0.01, 40.0, n)
    gaps = np.where(rng.uniform(size=n) < 0.1, rng.uniform(0, 300, n), 0.0)
    start = np.cumsum(dur + gaps) - dur + rng.uniform(0, 5)
    mfu = np.clip(rng.uniform(-0.05, 0.8, n), 0, None)
    return start, dur, mfu


def _assert_metrics_close(got, want):
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]), err_msg=k,
                                   **RTOL)


def _metric_scale(metrics, k):
    if k.endswith("_kwh"):
        return float(metrics["total_energy_kwh"])
    if k.endswith("_kg"):
        return float(metrics["total_emissions_nosolar_kg"])
    return 100.0 if k.endswith("_pct") else abs(float(metrics[k]))


def _assert_cosim_metrics_close(got, want):
    """Microgrid metrics: 5e-6 of the whole each one is a part of."""
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(
            float(got[k]), float(want[k]), rtol=0, err_msg=k,
            atol=DEVICE_MODE_RTOL * _metric_scale(want, k))


# ------------------------------------------------------------- Eq. 5 ---

@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("resolution_s", [1.0, 60.0, 300.0])
def test_aggregate_power_is_bitwise(seed, resolution_s):
    start, dur, mfu = _stages(seed)
    p = 100.0 + 300.0 * mfu
    want = rsig.aggregate_power(start, dur, p, resolution_s)
    got = psig.aggregate_power(start, dur, p, resolution_s)
    np.testing.assert_array_equal(got.times, want.times)
    np.testing.assert_array_equal(got.values, want.values)
    assert got.interp == want.interp


def test_aggregate_power_of_nothing_is_empty():
    sig = psig.aggregate_power(np.zeros(0), np.zeros(0), np.zeros(0))
    assert len(sig.times) == len(sig.values) == 0


def test_to_csv_is_bytewise(tmp_path):
    start, dur, mfu = _stages(1)
    sig = psig.aggregate_power(start, dur, mfu * 400.0)
    rsig.to_csv(sig, tmp_path / "ref.csv", name="load_w")
    psig.to_csv(sig, tmp_path / "port.csv", name="load_w")
    assert (tmp_path / "ref.csv").read_bytes() == \
        (tmp_path / "port.csv").read_bytes()


# ----------------------------------------------------------- datasets ---

@pytest.mark.parametrize("name", sorted(rd.CI_TRACES) + sorted(rd.CI_TRACE_FILES))
def test_ci_traces_are_bitwise(name):
    want, got = rd.ci_trace_signal(name, 30.0), pd.ci_trace_signal(name, 30.0)
    np.testing.assert_array_equal(got.times, want.times)
    np.testing.assert_array_equal(got.values, want.values)


@pytest.mark.parametrize("seed,cloudiness,offset", [(0, 0.25, 0.0),
                                                   (3, 0.12, 0.0),
                                                   (7, 0.5, 5.0)])
def test_solar_and_ci_generators_are_bitwise(seed, cloudiness, offset):
    for fn, kw in (("solar_signal", dict(cloudiness=cloudiness)),
                   ("carbon_intensity_signal", {})):
        want = getattr(rd, fn)(30.0, seed=seed, day_offset_h=offset, **kw)
        got = getattr(pd, fn)(30.0, seed=seed, day_offset_h=offset, **kw)
        np.testing.assert_array_equal(got.times, want.times)
        np.testing.assert_array_equal(got.values, want.values)
        assert got.interp == want.interp


def test_bundled_csv_is_the_references():
    assert pd.CI_TRACE_FILES["caiso-em"].read_bytes() == \
        rd.CI_TRACE_FILES["caiso-em"].read_bytes()
    want = rd.load_ci_csv(rd.CI_TRACE_FILES["caiso-em"])
    got = pd.load_ci_csv(pd.CI_TRACE_FILES["caiso-em"])
    np.testing.assert_array_equal(got.times, want.times)
    np.testing.assert_array_equal(got.values, want.values)


# ----------------------------------------------------------- policies ---

@pytest.mark.parametrize("seed", range(3))
def test_policies_are_bitwise(seed):
    rng = np.random.default_rng(seed)
    load = rng.uniform(50, 400, 1440)
    ci = np.asarray(rd.carbon_intensity_signal(24, seed=seed).values)
    solar = np.asarray(rd.solar_signal(24, capacity_w=600, seed=seed).values)
    for fn, args in (("threshold_deferral", (load, ci)),
                     ("solar_following", (load, solar)),
                     ("multi_region", (load, np.stack([ci, ci[::-1]])))):
        want, got = getattr(rpol, fn)(*args), getattr(ppol, fn)(*args)
        if isinstance(want, tuple):
            np.testing.assert_array_equal(got[0], want[0])
            assert got[1] == want[1]
        else:
            np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------- Eqs. 1-3 ---

@pytest.mark.parametrize("device", ["a100", "h100", "a40"])
def test_energy_wh_matches_reference(device):
    _, dur, mfu = _stages(2)
    want = float(rc.PowerModel(device).energy_wh(mfu, dur, n_devices=2, pue=1.2))
    got = pc.PowerModel(device, torch_device=CPU).energy_wh(mfu, dur, 2, 1.2)
    assert got.dtype == torch.float32 and got.device.type == CPU
    np.testing.assert_allclose(float(got), want, **RTOL)


def test_power_model_returns_float32_on_its_device():
    p = pc.PowerModel("a100", torch_device=CPU).power(np.array([0.0, 0.45, 1.0]))
    assert p.dtype == torch.float32 and p.device.type == CPU
    np.testing.assert_array_equal(p.numpy(), np.float32([100.0, 400.0, 400.0]))


@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("device", ["a100", "h100"])
def test_energy_reports_match_reference(seed, device):
    start, dur, mfu = _stages(seed)
    rng = np.random.default_rng(seed)
    f_mlp, f_attn = rng.uniform(1e12, 1e14, (2, len(dur)))
    np.testing.assert_array_equal(
        pc.stage_mfu(f_mlp, f_attn, dur, pc.DEVICES[device], 2),
        rc.stage_mfu(f_mlp, f_attn, dur, rc.DEVICES[device], 2))
    pues = (1.0, 1.2, 1.58)
    want = rc.stacked_energy_reports(mfu, dur, rc.PowerModel(device), 4, pues)
    got = pc.stacked_energy_reports(
        mfu, dur, pc.PowerModel(device, torch_device=CPU), 4, pues)
    trace = types.SimpleNamespace(start_s=start, dur_s=dur, mfu=mfu)
    want.append(rc.operational_energy_trace(trace, rc.PowerModel(device), 3, 1.1))
    got.append(pc.operational_energy_trace(
        trace, pc.PowerModel(device, torch_device=CPU), 3, 1.1))
    for g, w in zip(got, want):
        _assert_metrics_close(dataclasses.asdict(g), dataclasses.asdict(w))


# ------------------------------------------------------------- Eq. 4 ---

def test_emissions_batch_is_bitwise():
    rng = np.random.default_rng(0)
    e, h, ci = rng.uniform(0, 1e4, (3, 16))
    want = rc.emissions_batch(e, h, rc.DEVICES["a100"], ci)
    got = pc.emissions_batch(e, h, pc.DEVICES["a100"], ci)
    assert [dataclasses.asdict(g) for g in got] == \
        [dataclasses.asdict(w) for w in want]
    row = pc.emissions(float(e[3]), float(h[3]), pc.DEVICES["a100"], float(ci[3]))
    assert dataclasses.asdict(row) == dataclasses.asdict(got[3])


@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("trace_name", ["caiso", "coal-evening", "caiso-em"])
def test_stage_attributed_carbon_matches_reference(seed, trace_name):
    start, dur, mfu = _stages(seed)
    trace = types.SimpleNamespace(start_s=start, dur_s=dur, mfu=mfu)
    want = rc.stage_attributed_carbon(trace, rc.PowerModel("a100"), 2, 1.2,
                                      rd.ci_trace_signal(trace_name, 4.0))
    got = pc.stage_attributed_carbon(trace, pc.PowerModel("a100", CPU), 2, 1.2,
                                     pd.ci_trace_signal(trace_name, 4.0))
    np.testing.assert_allclose(got, want, **RTOL)
    empty = types.SimpleNamespace(start_s=np.zeros(0), dur_s=np.zeros(0),
                                  mfu=np.zeros(0))
    assert pc.stage_attributed_carbon(empty, pc.PowerModel("a100", CPU), 1,
                                      1.0, pd.ci_trace_signal("caiso", 1.0)) == 0.0


# ---------------------------------------------------------- microgrid ---

MICROGRIDS = {
    "default": rc.MicrogridConfig(),
    "table1b": rc.MicrogridConfig(battery=rc.BatteryConfig(
        capacity_wh=100.0, soc_init=0.5, soc_min=0.2, soc_max=0.8)),
    "empty-battery": rc.MicrogridConfig(battery=rc.BatteryConfig(
        capacity_wh=0.0)),
    "slow-5min": rc.MicrogridConfig(step_s=300.0, battery=rc.BatteryConfig(
        capacity_wh=500.0, soc_init=0.2, max_charge_w=150.0,
        max_discharge_w=90.0, efficiency=0.9)),
}


def _port_cfg(cfg):
    return pc.MicrogridConfig(battery=pc.BatteryConfig(
        **dataclasses.asdict(cfg.battery)), step_s=cfg.step_s,
        ci_threshold_low=cfg.ci_threshold_low,
        ci_threshold_high=cfg.ci_threshold_high)


def _grid_inputs(seed, T, load_scale=600.0, solar_scale=800.0):
    rng = np.random.default_rng(seed)
    return (rng.uniform(0, load_scale, T), rng.uniform(0, solar_scale, T),
            rng.uniform(50, 800, T))


@pytest.mark.parametrize("name", list(MICROGRIDS))
@pytest.mark.parametrize("seed", range(2))
def test_microgrid_matches_reference(name, seed):
    import jax.numpy as jnp
    cfg = MICROGRIDS[name]
    load, solar, ci = (x.astype(np.float32) for x in _grid_inputs(seed, 1800))
    want = {k: np.asarray(v) for k, v in
            rc.simulate(*map(jnp.asarray, (load, solar, ci)), cfg).items()}
    got = pc.simulate(load, solar, ci, _port_cfg(cfg), torch_device=CPU)
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == torch.float32 and got[k].shape == (1800,)
        scale = max(float(np.abs(want[k]).max()), 1e-30)
        np.testing.assert_allclose(got[k].numpy(), want[k], rtol=0,
                                   atol=1e-5 * scale, err_msg=k)
    got_np = {k: v.numpy() for k, v in got.items()}
    _assert_cosim_metrics_close(
        pc.summarize(load, solar, ci, got_np, _port_cfg(cfg)),
        rc.summarize(load, solar, ci, want, cfg))


def test_microgrid_of_no_steps_is_empty():
    tr = pc.simulate(np.zeros(0), np.zeros(0), np.zeros(0), pc.MicrogridConfig(),
                     torch_device=CPU)
    assert all(v.shape == (0,) for v in tr.values())


# the reference's hypothesis properties (tests/test_microgrid_policies.py),
# as fixed cases: power balance every step, SoC inside its bounds
@pytest.mark.parametrize("seed,load_scale,solar_scale",
                         [(0, 50.0, 0.0), (1, 2000.0, 1500.0), (2, 300.0, 800.0),
                          (3, 900.0, 100.0), (4, 120.0, 1400.0)])
def test_microgrid_balances_power_and_keeps_soc_in_bounds(seed, load_scale,
                                                          solar_scale):
    load, solar, ci = _grid_inputs(seed, 200, load_scale, solar_scale)
    cfg = pc.MicrogridConfig(battery=pc.BatteryConfig(capacity_wh=100.0))
    tr = {k: v.numpy() for k, v in
          pc.simulate(load, solar, ci, cfg, torch_device=CPU).items()}
    load32, solar32 = load.astype(np.float32), solar.astype(np.float32)
    np.testing.assert_allclose(load32 + tr["charge_w"] + tr["grid_export_w"],
                               solar32 + tr["discharge_w"] + tr["grid_import_w"],
                               rtol=1e-5, atol=1e-3)
    assert np.all(tr["soc"] >= cfg.battery.soc_min - 1e-5)
    assert np.all(tr["soc"] <= cfg.battery.soc_max + 1e-5)


# ------------------------------------------------------------- co-sim ---

@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("include_idle", [True, False])
def test_load_signals_match_reference(seed, include_idle):
    start, dur, mfu = _stages(seed)
    kw = dict(n_devices=2, pue=1.2, resolution_s=60.0, include_idle=include_idle)
    want = rc.stages_to_load_signal(start, dur, mfu, rc.PowerModel("a100"), **kw)
    got = pc.stages_to_load_signal(start, dur, mfu,
                                   pc.PowerModel("a100", torch_device=CPU), **kw)
    np.testing.assert_array_equal(got.times, want.times)
    np.testing.assert_allclose(got.values, want.values, **RTOL)
    trace = types.SimpleNamespace(start_s=start, dur_s=dur, mfu=mfu)
    again = pc.trace_to_load_signal(trace, pc.PowerModel("a100", torch_device=CPU),
                                    **kw)
    np.testing.assert_array_equal(again.values, got.values)


@pytest.mark.parametrize("seed", range(2))
@pytest.mark.parametrize("name", ["default", "table1b"])
def test_run_cosim_matches_reference(seed, name):
    start, dur, mfu = _stages(seed, n=600)
    want_load = rc.stages_to_load_signal(start, dur, mfu, rc.PowerModel("a100"))
    got_load = pc.stages_to_load_signal(start, dur, mfu,
                                        pc.PowerModel("a100", torch_device=CPU))
    hours = got_load.times[-1] / 3600.0 + 0.1
    want = rc.run_cosim(want_load, rd.solar_signal(hours, seed=3),
                        rd.carbon_intensity_signal(hours, seed=4),
                        MICROGRIDS[name])
    got = pc.run_cosim(got_load, pd.solar_signal(hours, seed=3),
                       pd.carbon_intensity_signal(hours, seed=4),
                       _port_cfg(MICROGRIDS[name]), torch_device=CPU)
    _assert_cosim_metrics_close(got.metrics, want.metrics)
    np.testing.assert_array_equal(got.solar.values, want.solar.values)
    np.testing.assert_array_equal(got.ci.values, want.ci.values)
    for k in want.traces:
        scale = max(float(np.abs(want.traces[k]).max()), 1e-30)
        np.testing.assert_allclose(got.traces[k], want.traces[k], rtol=0,
                                   atol=1e-5 * scale, err_msg=k)
