"""Carbon accounting (paper Eq. 4).

    C = E_op * CI + H * phi_manuf

with static or time-varying grid carbon intensity CI (gCO2/kWh) and
per-GPU-hour embodied carbon phi_manuf.

``emissions_batch`` stacks Eq. 4 over aligned (energy, CI) axes in one
pass — the sweep engine's vectorized mode evaluates a whole grid-CI
axis against a shared trace through it. ``stage_attributed_carbon``
consumes a ``StageTrace`` directly: per-stage Eq. 2-3 energy weighted
by the live CI each stage ran under (no idle fill), the request-
attributable quantity temporal/spatial scheduling moves.

Counterpart of ``repro.core.carbon``; Eq. 1 inside
``stage_attributed_carbon`` runs where its ``PowerModel`` says.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Union

import numpy as np

from repro_torch.core.power import DeviceProfile, PowerModel
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


def emissions_batch(energy_wh: Sequence[float], gpu_hours: Sequence[float],
                    device: DeviceProfile, ci: Sequence[float]
                    ) -> List[CarbonReport]:
    """Eq. 4 stacked over aligned scenario axes (static CI only): one
    array pass over the (energy, gpu_hours, ci) triples. Elementwise
    float64 ops round exactly like the scalar arithmetic in
    ``emissions``, so the reports are bit-identical to per-scenario
    calls (pinned by the runner-mode equality tests)."""
    e = np.asarray(energy_wh, np.float64)
    h = np.asarray(gpu_hours, np.float64)
    c = np.asarray(ci, np.float64)
    op_g = e / 1000.0 * c
    emb_g = h * device.embodied_kg_per_hour * 1000.0
    return reports_from_arrays(op_g, emb_g, op_g + emb_g, c)


def reports_from_arrays(op_g: Sequence[float], emb_g: Sequence[float],
                        total_g: Sequence[float], ci: Sequence[float]
                        ) -> List[CarbonReport]:
    """Assemble ``CarbonReport`` rows from already-evaluated aligned
    Eq. 4 terms — shared by ``emissions_batch`` (numpy pass) and the
    sweep's device mode (the same elementwise ops inside one device
    program, which round identically; only reductions upstream of the
    energy inputs can differ)."""
    return [CarbonReport(operational_g=float(o), embodied_g=float(m),
                         total_g=float(t), avg_ci=float(a))
            for o, m, t, a in zip(op_g, emb_g, total_g, ci)]


def stage_attributed_carbon(trace, power_model: PowerModel,
                            n_devices: int, pue: float,
                            ci: Signal) -> float:
    """Per-stage Eq. 2-3 energy x the live grid CI at each stage's
    start (gCO2), in one array pass over the ``StageTrace``. No idle
    fill — this is active (stage-time) carbon, immune to the Eq. 5
    bin quantization of co-sim totals."""
    if len(trace.start_s) == 0:
        return 0.0
    stage_wh = (power_model.power(trace.mfu).cpu().numpy() * trace.dur_s
                / 3600.0 * n_devices * pue)
    return float(np.sum(stage_wh * ci.at(trace.start_s)) / 1000.0)
