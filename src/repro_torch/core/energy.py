"""Operational energy accounting (paper Eqs. 2-3).

    MFU_i = (FLOPs_MLP(i) + FLOPs_Attn(i)) / (DeviceFLOPs * t_i)
    G     = R * TP * PP                      (GPUs per deployment)
    H_i   = dt_i / 3600 * G                  (GPU-hours of stage i)
    E_op  = sum_i P(MFU_i) * H_i * PUE       (Wh)

All entry points are single array passes over a stage trace; the
``stacked_energy_reports`` variant evaluates a whole axis of PUE
values against one shared trace (per-stage power computed once) and is
bit-identical to calling ``operational_energy`` per value — the sweep
engine's vectorized mode relies on that equality.

Counterpart of ``repro.core.energy``. Eq. 1 runs where the
``PowerModel`` says (its ``torch_device``); its float32 watts come back to
the host before any float64 arithmetic, so the port rounds as the
reference does (float32 power times float64 durations).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

import numpy as np

from repro_torch.core.power import DeviceProfile, PowerModel


@dataclasses.dataclass
class EnergyReport:
    energy_wh: float
    gpu_hours: float
    avg_power_w: float          # duration-weighted mean per-GPU power
    peak_power_w: float
    avg_mfu: float
    duration_s: float
    n_devices: int
    pue: float

    def as_dict(self) -> Dict:
        return dataclasses.asdict(self)


def stage_mfu(flops_mlp: np.ndarray, flops_attn: np.ndarray,
              stage_dur_s: np.ndarray, device: DeviceProfile,
              n_devices: int = 1) -> np.ndarray:
    """Eq. 2 (as a fraction, not percent)."""
    total = np.asarray(flops_mlp, np.float64) + np.asarray(flops_attn, np.float64)
    dt = np.maximum(np.asarray(stage_dur_s, np.float64), 1e-12)
    return total / (device.peak_flops * dt * n_devices)


def operational_energy(mfu: np.ndarray, stage_dur_s: np.ndarray,
                       power_model: PowerModel, n_devices: int = 1,
                       pue: float = 1.0) -> EnergyReport:
    """Eq. 3. mfu per stage (fraction), durations in seconds."""
    return stacked_energy_reports(mfu, stage_dur_s, power_model,
                                  n_devices=n_devices, pues=(pue,))[0]


def reports_from_sums(e_sum: float, m_sum: float, dur: float, peak: float,
                      n_devices: int = 1, pues: Sequence[float] = (1.0,)
                      ) -> List[EnergyReport]:
    """Eq. 3 report assembly from the trace-level reductions alone:
    ``e_sum`` = sum(P_i * dt_i) in W*s, ``m_sum`` = sum(MFU_i * dt_i),
    ``dur`` = sum(dt_i), ``peak`` = max(P_i). One report per PUE value.

    This is the single source of the report-assembly float sequence —
    ``stacked_energy_reports`` feeds it numpy reductions; the sweep's
    device mode feeds it the same reductions computed on-device (which
    reassociate, hence that mode's ulp-level tolerance contract)."""
    dur = float(dur)
    gpu_h = dur / 3600.0 * n_devices
    avg_power = float(e_sum / max(dur, 1e-12))
    avg_mfu = float(m_sum / max(dur, 1e-12))
    return [EnergyReport(
        energy_wh=float(e_sum / 3600.0 * n_devices * pue),
        gpu_hours=gpu_h,
        avg_power_w=avg_power,
        peak_power_w=float(peak),
        avg_mfu=avg_mfu,
        duration_s=dur,
        n_devices=n_devices,
        pue=pue,
    ) for pue in pues]


def stacked_energy_reports(mfu: np.ndarray, stage_dur_s: np.ndarray,
                           power_model: PowerModel, n_devices: int = 1,
                           pues: Sequence[float] = (1.0,)
                           ) -> List[EnergyReport]:
    """Eq. 3 stacked over a PUE axis: one array pass over the shared
    stage trace (per-stage power evaluated once), then one report per
    PUE value. Energy is linear in PUE, so the stacked reports are
    bit-identical to per-value ``operational_energy`` calls."""
    mfu = np.asarray(mfu, np.float64)
    dt = np.asarray(stage_dur_s, np.float64)
    p = power_model.power(mfu).cpu().numpy()                 # W per device, f32
    e_sum = np.sum(p * dt)                                   # W*s
    m_sum = np.sum(mfu * dt)
    dur = float(dt.sum())
    peak = float(p.max()) if len(p) else 0.0
    return reports_from_sums(e_sum, m_sum, dur, peak,
                             n_devices=n_devices, pues=pues)


def operational_energy_trace(trace, power_model: PowerModel,
                             n_devices: int = 1,
                             pue: float = 1.0) -> EnergyReport:
    """Eq. 2-3 directly over a ``StageTrace``."""
    return operational_energy(trace.mfu, trace.dur_s, power_model,
                              n_devices=n_devices, pue=pue)
