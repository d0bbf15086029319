"""Vessim-analogue microgrid co-simulation, one kernel launch per run.

Actors (load, solar), a battery with SoC constraints (the ``ClcBattery``
analogue), and a grid connection are stepped at fixed resolution
(default 1 minute).

Power-flow convention per step (all W, averaged over the step):
  load >= 0 (consumption), solar >= 0 (generation)
  surplus = solar - load
  surplus > 0: charge battery (up to c-rate/SoC-max), export remainder
  surplus < 0: discharge battery (down to SoC-min), import remainder

Counterpart of ``repro.core.microgrid``. The reference's ``lax.scan`` runs
in float32 (x64 is off), so this scan does too: inputs, state and every
constant are float32, on ``torch_device``. XLA compiles the reference's
step with each division by a constant turned into a product with its
float32 reciprocal and the constants of a chain folded into one
(``room / dt_h / eff`` is ``room * ((1 / dt_h) * (1 / eff))``); the scan
takes the same folded constants (``constants``). Its traces agree with the
reference's within 1e-5 of their largest value on the CPU, most steps bit
for bit (the compiled scan still rounds some steps apart, and a battery
decision that flips on a one-ulp SoC difference moves its step by more).
The steps run in ``kernels.microgrid_scan``: on the card one launch of its
CUDA kernel walks the whole trace, on the CPU its plain step loop does;
the two agree bit for bit on one device. ``summarize`` is numpy, as in the
reference.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.kernels.microgrid_scan.ops import microgrid_scan
from repro_torch.kernels.microgrid_scan.ref import TRACE_KEYS


@dataclasses.dataclass(frozen=True)
class BatteryConfig:
    capacity_wh: float = 100.0
    soc_init: float = 0.5
    soc_min: float = 0.2
    soc_max: float = 0.8
    max_charge_w: float = 1000.0
    max_discharge_w: float = 1000.0
    efficiency: float = 0.95        # round-trip split evenly


@dataclasses.dataclass(frozen=True)
class MicrogridConfig:
    battery: BatteryConfig = BatteryConfig()
    step_s: float = 60.0
    ci_threshold_low: float = 100.0    # gCO2/kWh (paper Table 1b)
    ci_threshold_high: float = 200.0


def constants(cfg: MicrogridConfig) -> Tuple[np.float32, ...]:
    """The scan's float32 constants, folded as XLA folds the reference's,
    in the order of ``kernels.microgrid_scan.ops.CONSTANTS``."""
    b = cfg.battery
    f32 = np.float32
    one, dt_h = f32(1.0), f32(cfg.step_s / 3600.0)
    eff = np.sqrt(f32(b.efficiency))
    with np.errstate(divide="ignore"):              # no battery: soc is nan
        k_soc = one / f32(b.capacity_wh)            # soc_wh / capacity_wh
    return (f32(b.soc_init * b.capacity_wh),        # soc_wh at step 0
            f32(b.soc_max * b.capacity_wh), f32(b.soc_min * b.capacity_wh),
            f32(b.max_charge_w), f32(b.max_discharge_w),
            (one / dt_h) * (one / eff),             # room / dt_h / eff
            eff * (one / dt_h),                     # avail * eff / dt_h
            eff * dt_h,                             # charge * eff * dt_h
            (one / eff) * dt_h,                     # discharge / eff * dt_h
            dt_h * (one / f32(1000.0)),             # import * dt_h / 1000
            k_soc)


def simulate(load_w, solar_w, ci, cfg: MicrogridConfig,
             torch_device: DeviceLike = None) -> Dict[str, torch.Tensor]:
    """Run the co-simulation. load/solar/ci: (T,) aligned at cfg.step_s,
    numpy arrays or tensors, taken as float32 on ``torch_device``.

    Returns the per-step traces, float32 tensors of shape (T,) there."""
    dev = resolve_device(torch_device)
    rows = [torch.as_tensor(x, dtype=torch.float32, device=dev).reshape(1, -1)
            for x in (load_w, solar_w, ci)]
    out = microgrid_scan(*(r.contiguous() for r in rows), constants(cfg))
    return {key: out[j, 0] for j, key in enumerate(TRACE_KEYS)}


def summarize(load_w, solar_w, ci, tr, cfg: MicrogridConfig) -> Dict[str, float]:
    """Aggregate metrics matching the paper's Table 2."""
    dt_h = cfg.step_s / 3600.0
    load = np.asarray(load_w)
    solar = np.asarray(solar_w)
    ci = np.asarray(ci)
    soc = np.asarray(tr["soc"])
    imp = np.asarray(tr["grid_import_w"])
    chg = np.asarray(tr["charge_w"])
    dis = np.asarray(tr["discharge_w"])
    emis = np.asarray(tr["emissions_g"])
    solar_used = np.asarray(tr["solar_used_w"])

    e_total = load.sum() * dt_h                     # Wh
    e_solar_gen = solar.sum() * dt_h
    e_solar_used = solar_used.sum() * dt_h
    e_grid = imp.sum() * dt_h
    total_emis = emis.sum()
    # counterfactual: all load from grid at prevailing CI
    emis_nosolar = float(np.sum(load * ci) * dt_h / 1000.0)
    offset = emis_nosolar - total_emis
    b = cfg.battery
    full_cycles = float(chg.sum() * dt_h / max(b.capacity_wh, 1e-9))
    return {
        "total_energy_kwh": e_total / 1000.0,
        "solar_generation_kwh": e_solar_gen / 1000.0,
        "grid_consumption_kwh": e_grid / 1000.0,
        "renewable_share_pct": 100.0 * e_solar_used / max(e_total, 1e-9),
        "grid_dependency_pct": 100.0 * e_grid / max(e_total, 1e-9),
        "total_emissions_nosolar_kg": emis_nosolar / 1000.0,
        "net_emissions_kg": total_emis / 1000.0,
        "offset_kg": offset / 1000.0,
        "carbon_offset_pct": 100.0 * offset / max(emis_nosolar, 1e-9),
        "avg_soc_pct": 100.0 * float(soc.mean()) if len(soc) else 0.0,
        "hours_below_50_soc": float(np.sum(soc < 0.5) * dt_h),
        "hours_above_80_soc": float(np.sum(soc >= 0.795) * dt_h),
        "charging_pct": 100.0 * float(np.mean(chg > 1e-6)),
        "discharging_pct": 100.0 * float(np.mean(dis > 1e-6)),
        "idle_pct": 100.0 * float(np.mean((chg <= 1e-6) & (dis <= 1e-6))),
        "battery_full_cycles": full_cycles,
        "avg_ci": float(ci.mean()),
        "hours_high_ci": float(np.sum(ci > cfg.ci_threshold_high) * dt_h),
        "duration_h": len(load) * dt_h,
    }
