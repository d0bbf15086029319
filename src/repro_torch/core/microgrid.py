"""Vessim-analogue microgrid co-simulation as a torch step loop.

Actors (load, solar), a battery with SoC constraints (the ``ClcBattery``
analogue), and a grid connection are stepped at fixed resolution
(default 1 minute).

Power-flow convention per step (all W, averaged over the step):
  load >= 0 (consumption), solar >= 0 (generation)
  surplus = solar - load
  surplus > 0: charge battery (up to c-rate/SoC-max), export remainder
  surplus < 0: discharge battery (down to SoC-min), import remainder

Counterpart of ``repro.core.microgrid``. The reference's ``lax.scan`` runs
in float32 (x64 is off), so this loop does too: inputs, state and every
constant are float32, on ``torch_device``. XLA compiles the reference's
step with each division by a constant turned into a product with its
float32 reciprocal and the constants of a chain folded into one
(``room / dt_h / eff`` is ``room * ((1 / dt_h) * (1 / eff))``); the loop
takes the same folded constants. Its traces agree with the reference's
within 1e-5 of their largest value on the CPU, most steps bit for bit
(the compiled scan still rounds some steps apart, and a battery decision
that flips on a one-ulp SoC difference moves its step by more). Each step
is 26 tensor operations of one element, one launch each on the card: the
loop is bound by launches, not by the device. ``summarize`` is
numpy, as in the reference.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device


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


TRACE_KEYS = ("soc", "grid_import_w", "grid_export_w", "charge_w",
              "discharge_w", "emissions_g", "solar_used_w")


def simulate(load_w, solar_w, ci, cfg: MicrogridConfig,
             torch_device: DeviceLike = None) -> Dict[str, torch.Tensor]:
    """Run the co-simulation. load/solar/ci: (T,) aligned at cfg.step_s,
    numpy arrays or tensors, taken as float32 on ``torch_device``.

    Returns the per-step traces, float32 tensors of shape (T,) there."""
    dev = resolve_device(torch_device)
    f32 = lambda x: torch.as_tensor(x, dtype=torch.float32, device=dev)
    load_w, solar_w, ci = f32(load_w), f32(solar_w), f32(ci)
    b = cfg.battery
    # the reference's constants in float32, folded as XLA folds them
    one, dt_h = np.float32(1.0), np.float32(cfg.step_s / 3600.0)
    eff = np.sqrt(np.float32(b.efficiency))
    k_room = f32((one / dt_h) * (one / eff))       # room / dt_h / eff
    k_avail = f32(eff * (one / dt_h))               # avail * eff / dt_h
    k_charge = f32(eff * dt_h)                      # charge * eff * dt_h
    k_discharge = f32((one / eff) * dt_h)           # discharge / eff * dt_h
    k_emis = f32(dt_h * (one / np.float32(1000.0)))  # import * dt_h / 1000
    with np.errstate(divide="ignore"):              # no battery: soc is nan
        k_soc = f32(one / np.float32(b.capacity_wh))  # soc_wh / capacity_wh
    soc_hi, soc_lo = f32(b.soc_max * b.capacity_wh), f32(b.soc_min * b.capacity_wh)
    max_chg, max_dis_w, zero = f32(b.max_charge_w), f32(b.max_discharge_w), f32(0.0)

    soc_wh = f32(b.soc_init * b.capacity_wh)
    out = {key: [] for key in TRACE_KEYS}
    for load, solar, ci_t in zip(load_w, solar_w, ci):
        surplus = solar - load
        # charge path
        room = torch.maximum(soc_hi - soc_wh, zero)
        charge = torch.clamp(surplus, zero, torch.minimum(max_chg, room * k_room))
        # discharge path
        avail = torch.maximum(soc_wh - soc_lo, zero)
        max_dis = torch.minimum(max_dis_w, avail * k_avail)
        discharge = torch.clamp(-surplus, zero, max_dis)
        soc_wh = soc_wh + charge * k_charge - discharge * k_discharge
        grid = surplus - charge + discharge   # >0 export, <0 import
        grid_import = torch.maximum(-grid, zero)
        for key, val in zip(TRACE_KEYS, (
                soc_wh * k_soc, grid_import, torch.maximum(grid, zero), charge,
                discharge, grid_import * k_emis * ci_t,
                torch.minimum(solar, load + charge))):
            out[key].append(val)
    return {key: torch.stack(vals) if vals else load_w.new_zeros(0)
            for key, vals in out.items()}


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
