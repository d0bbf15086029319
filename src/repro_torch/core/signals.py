"""Time-series signals: the Vessim ``HistoricalSignal`` analogue + the
Eq. 5 variable-duration -> fixed-resolution aggregation pipeline.

A ``Signal`` is (times_s, values) with interpolation ("previous", "linear",
"cubic"). ``aggregate_power`` converts the simulator's variable-duration
batch-stage power sequence into fixed bins with the paper's
duration-weighted average:

    P_bar = sum_i P_i * dt_i / sum_i dt_i                      (Eq. 5)

Numpy copy of ``repro.core.signals``: bit-identical to it.
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


def aggregate_power(stage_start_s: np.ndarray, stage_dur_s: np.ndarray,
                    stage_power_w: np.ndarray, resolution_s: float = 60.0
                    ) -> Signal:
    """Eq. 5: duration-weighted binning of per-batch-stage power into a
    fixed-resolution load profile.

    Stages may straddle bin edges; each stage's power contributes to a bin
    weighted by its overlap with the bin."""
    start = np.asarray(stage_start_s, np.float64)
    dur = np.asarray(stage_dur_s, np.float64)
    power = np.asarray(stage_power_w, np.float64)
    if len(start) == 0:
        return Signal(np.zeros(0), np.zeros(0))
    end = start + dur
    t0 = np.floor(start.min() / resolution_s) * resolution_s
    t1 = np.ceil(end.max() / resolution_s) * resolution_s
    n_bins = max(1, int(round((t1 - t0) / resolution_s)))
    acc = np.zeros(n_bins)
    wsum = np.zeros(n_bins)
    first_bin = np.floor((start - t0) / resolution_s).astype(int)
    last_bin = np.ceil((end - t0) / resolution_s).astype(int) - 1
    max_span = int(np.max(last_bin - first_bin)) + 1 if len(start) else 1
    for k in range(max_span):
        b = first_bin + k
        in_range = b <= last_bin
        bs = t0 + b * resolution_s
        be = bs + resolution_s
        overlap = np.clip(np.minimum(end, be) - np.maximum(start, bs),
                          0.0, None) * in_range
        np.add.at(acc, np.clip(b, 0, n_bins - 1), power * overlap)
        np.add.at(wsum, np.clip(b, 0, n_bins - 1), overlap)
    vals = np.where(wsum > 0, acc / np.maximum(wsum, 1e-12), 0.0)
    # idle bins draw zero *dynamic* load; callers add idle power explicitly
    times = t0 + np.arange(n_bins) * resolution_s
    return Signal(times, vals, interp="previous")


def to_csv(signal: Signal, path: str, name: str = "value"):
    """Vessim-style load-profile CSV export."""
    with open(path, "w") as f:
        f.write(f"time_s,{name}\n")
        for t, v in zip(signal.times, signal.values):
            f.write(f"{t:.3f},{v:.6f}\n")
