"""Time-series signals: the Vessim ``HistoricalSignal`` analogue.

A ``Signal`` is (times_s, values) with interpolation ("previous", "linear",
"cubic"). Numpy copy of ``repro.core.signals.Signal``; the Eq. 5 aggregation
that lives beside it in the reference is ported with the simulated path.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np


@dataclasses.dataclass
class Signal:
    """Time-indexed signal. times in seconds (monotonic), values float."""
    times: np.ndarray
    values: np.ndarray
    interp: str = "previous"          # previous | linear | cubic
    fill: float = 0.0

    def __post_init__(self):
        self.times = np.asarray(self.times, np.float64)
        self.values = np.asarray(self.values, np.float64)
        if self.times.ndim != 1 or self.times.shape != self.values.shape:
            raise ValueError("times and values must be 1-D of equal length")
        if len(self.times) > 1 and np.any(np.diff(self.times) < 0):
            raise ValueError("times must be sorted")

    def at(self, t) -> np.ndarray:
        """Sample the signal at time(s) t."""
        t = np.asarray(t, np.float64)
        if len(self.times) == 0:
            return np.full_like(t, self.fill, dtype=np.float64)
        if self.interp == "previous":
            idx = np.searchsorted(self.times, t, side="right") - 1
            return np.where(idx >= 0, self.values[np.clip(idx, 0, None)],
                            self.fill)
        if self.interp == "linear":
            return np.interp(t, self.times, self.values,
                             left=self.fill, right=self.values[-1])
        if self.interp == "cubic":
            from scipy.interpolate import CubicSpline
            if len(self.times) < 4:
                return np.interp(t, self.times, self.values,
                                 left=self.fill, right=self.values[-1])
            cs = CubicSpline(self.times, self.values)
            out = cs(np.clip(t, self.times[0], self.times[-1]))
            return np.asarray(out, np.float64)
        raise ValueError(self.interp)

    def resample(self, resolution_s: float, t0: Optional[float] = None,
                 t1: Optional[float] = None) -> "Signal":
        t0 = self.times[0] if t0 is None else t0
        t1 = self.times[-1] if t1 is None else t1
        grid = np.arange(t0, t1 + resolution_s * 0.5, resolution_s)
        return Signal(grid, self.at(grid), interp=self.interp, fill=self.fill)
