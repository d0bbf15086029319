"""Carbon-intensity forecasting for admission policies.

Policies never see the future of the actual grid signal — they see a
``Forecaster``'s prediction of it, so forecast error is a first-class
axis of the shifting experiments (oracle = perfect foresight upper
bound, persistence = no-skill baseline, diurnal template = the shape
prior a production scheduler would actually run on).

A forecaster maps (history-bearing signal, decision time, query times)
to predicted values; it must only read ``signal`` at times <= ``t_now``
— except the oracle, whose whole point is cheating.
"""
from __future__ import annotations

from typing import Dict, Type

import numpy as np

from repro_torch.core.signals import Signal


class Forecaster:
    """Predict a signal's values at future times, from its past."""

    name = "base"

    def predict(self, signal: Signal, t_now_s: float,
                ts: np.ndarray) -> np.ndarray:
        raise NotImplementedError


class OracleForecaster(Forecaster):
    """Perfect foresight: the prediction IS the trace. Upper bound on
    what any admission policy can extract from temporal shifting."""

    name = "oracle"

    def predict(self, signal, t_now_s, ts):
        return np.asarray(signal.at(np.asarray(ts, np.float64)))


class PersistenceForecaster(Forecaster):
    """No-skill baseline: CI stays at its current value forever. Under
    persistence every future instant looks equally good, so
    deferral-for-carbon degenerates to (almost) immediate admission —
    the floor any real forecaster must beat."""

    name = "persistence"

    def predict(self, signal, t_now_s, ts):
        now = float(np.asarray(signal.at(t_now_s)))
        return np.full(np.asarray(ts, np.float64).shape, now)


class DiurnalTemplateForecaster(Forecaster):
    """Shape-prior forecast: scale the current observation by a duck-
    curve template of hour-of-day (midday solar dip, evening ramp —
    the same structure as ``core.datasets.carbon_intensity_signal``).

        pred(t) = ci(t_now) * template(hod(t)) / template(hod(t_now))

    ``swing_frac`` is the template's relative amplitude; ``phase_h``
    shifts it (regions east/west of the template's reference zone).
    """

    name = "diurnal"

    def __init__(self, swing_frac: float = 0.3, phase_h: float = 0.0):
        self.swing_frac = float(swing_frac)
        self.phase_h = float(phase_h)

    def _template(self, t_s) -> np.ndarray:
        hod = (np.asarray(t_s, np.float64) / 3600.0 + self.phase_h) % 24.0
        dip = -np.exp(-0.5 * ((hod - 13.0) / 2.5) ** 2)
        peak = 0.9 * np.exp(-0.5 * ((hod - 19.5) / 1.8) ** 2)
        return np.clip(1.0 + self.swing_frac * (dip + peak), 0.2, None)

    def predict(self, signal, t_now_s, ts):
        now = float(np.asarray(signal.at(t_now_s)))
        scale = now / float(self._template(t_now_s))
        return scale * self._template(ts)


FORECASTERS: Dict[str, Type[Forecaster]] = {
    "oracle": OracleForecaster,
    "persistence": PersistenceForecaster,
    "diurnal": DiurnalTemplateForecaster,
}


def make_forecaster(name: str, **params) -> Forecaster:
    if name not in FORECASTERS:
        raise KeyError(
            f"unknown forecaster {name!r}; have {sorted(FORECASTERS)}")
    return FORECASTERS[name](**params)
