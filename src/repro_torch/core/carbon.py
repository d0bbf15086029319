"""Carbon accounting (paper Eq. 4).

    C = E_op * CI + H * phi_manuf

with static or time-varying grid carbon intensity CI (gCO2/kWh) and
per-GPU-hour embodied carbon phi_manuf. Numpy copy of
``repro.core.carbon.emissions``.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Union

import numpy as np

from repro_torch.core.power import DeviceProfile
from repro_torch.core.signals import Signal


@dataclasses.dataclass
class CarbonReport:
    operational_g: float
    embodied_g: float
    total_g: float
    avg_ci: float


def emissions(energy_wh: float, gpu_hours: float, device: DeviceProfile,
              ci: Union[float, Signal],
              power_signal: Optional[Signal] = None) -> CarbonReport:
    """Eq. 4. With a time-varying CI signal, operational emissions are
    integrated against the power signal:  sum_t P(t) * CI(t) * dt."""
    if isinstance(ci, Signal):
        if power_signal is None:
            raise ValueError("time-varying CI needs a power signal")
        t = power_signal.times
        if len(t) >= 2:
            dt_h = float(np.median(np.diff(t))) / 3600.0
        else:
            dt_h = 1.0 / 60.0
        ci_t = ci.at(t)
        op_g = float(np.sum(power_signal.values * ci_t) * dt_h / 1000.0)
        avg_ci = float(np.mean(ci_t))
    else:
        op_g = energy_wh / 1000.0 * float(ci)
        avg_ci = float(ci)
    emb_g = gpu_hours * device.embodied_kg_per_hour * 1000.0
    return CarbonReport(operational_g=op_g, embodied_g=emb_g,
                        total_g=op_g + emb_g, avg_ci=avg_ci)
