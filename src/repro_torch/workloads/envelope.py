"""Rate envelopes and burst overlays for day-scale workloads.

The instantaneous arrival rate of a day-in-the-life workload is

    lambda(t) = qps * envelope(t) * burst(t)

where ``envelope`` is a smooth diurnal modulation (mean ~1 over a
period, so ``qps`` stays the day-average request rate) and ``burst`` is
an MMPP-style two-state overlay (a background/burst Markov-modulated
Poisson process): the rate multiplies by ``burst_gain`` during bursts,
with exponentially distributed burst/idle durations drawn from their
own seeded generator so the overlay never disturbs the length draws.

Everything here is deterministic per seed and evaluated as array
passes on a dense time grid; ``repro_torch.workloads.stream`` inverts the
cumulative rate to place arrivals.
"""
from __future__ import annotations

import dataclasses

import numpy as np

ENVELOPES = ("none", "sinusoidal", "diurnal")

# grid step (s) for cumulative-rate integration / inversion — fine
# enough to resolve minute-scale bursts, coarse enough that a week-long
# horizon stays a ~20k-point array
GRID_STEP_S = 30.0


def envelope_shape(name: str, t_s: np.ndarray, amplitude: float,
                   period_h: float, phase_h: float) -> np.ndarray:
    """Multiplicative diurnal modulation around 1.0 (clipped >= 0.05).

    ``sinusoidal``: 1 + A sin(2 pi (t + phase) / period).
    ``diurnal``: a two-peak weekday template (morning ramp, midday
    plateau, evening peak, overnight trough) — the canonical serving
    load-generator shape: a steady-state request loop whose Poisson
    arrival rate is modulated by an hour-of-day traffic profile.
    """
    t_s = np.asarray(t_s, np.float64)
    if name == "none":
        return np.ones_like(t_s)
    hod = (t_s / 3600.0 + phase_h) % period_h
    if name == "sinusoidal":
        shape = 1.0 + amplitude * np.sin(2.0 * np.pi * hod / period_h)
    elif name == "diurnal":
        # two-Gaussian peak template on a 24h-equivalent clock: morning
        # rise toward a midday plateau, a sharper evening peak, and an
        # early-morning trough; scaled so amplitude sets the swing
        h = hod * (24.0 / period_h)

        def peak(center, width):
            d = np.minimum(np.abs(h - center), 24.0 - np.abs(h - center))
            return np.exp(-0.5 * (d / width) ** 2)

        template = 0.75 * peak(11.0, 3.0) + peak(20.0, 2.5) - peak(4.0, 3.0)
        shape = 1.0 + amplitude * template
    else:
        raise ValueError(f"unknown envelope {name!r}; have {ENVELOPES}")
    return np.maximum(shape, 0.05)


@dataclasses.dataclass
class BurstOverlay:
    """Step function of the MMPP burst state: ``switch_s[i]`` is the
    time the multiplier changes to ``gain_at[i]`` (state 0 = 1.0)."""
    switch_s: np.ndarray
    gain_at: np.ndarray

    def at(self, t_s: np.ndarray) -> np.ndarray:
        t_s = np.asarray(t_s, np.float64)
        if len(self.switch_s) == 0:
            return np.ones_like(t_s)
        idx = np.searchsorted(self.switch_s, t_s, side="right") - 1
        out = np.ones_like(t_s)
        mask = idx >= 0
        out[mask] = self.gain_at[idx[mask]]
        return out

    def burst_windows(self):
        """(start, end) pairs of the burst-state intervals."""
        wins = []
        for i, g in enumerate(self.gain_at):
            if g != 1.0:
                end = (self.switch_s[i + 1]
                       if i + 1 < len(self.switch_s) else np.inf)
                wins.append((float(self.switch_s[i]), float(end)))
        return wins


def burst_overlay(seed: int, horizon_s: float, gain: float,
                  mean_on_s: float, mean_off_s: float) -> BurstOverlay:
    """Alternating exponential off/on (background/burst) state process.

    ``gain <= 1`` or ``mean_on_s <= 0`` disables the overlay (constant
    1.0). The state stream draws from its own generator keyed off the
    workload seed, so enabling bursts never shifts the length draws.
    """
    if gain <= 1.0 or mean_on_s <= 0.0:
        return BurstOverlay(np.empty(0), np.empty(0))
    rng = np.random.default_rng([seed, 0xB1157])
    switches, gains = [], []
    t = float(rng.exponential(mean_off_s))     # start in background state
    while t < horizon_s:
        on = float(rng.exponential(mean_on_s))
        switches.extend((t, t + on))
        gains.extend((gain, 1.0))
        t += on + float(rng.exponential(mean_off_s))
    return BurstOverlay(np.asarray(switches), np.asarray(gains))


def rate_on_grid(qps: float, envelope: str, amplitude: float,
                 period_h: float, phase_h: float, burst: BurstOverlay,
                 horizon_s: float, step_s: float = GRID_STEP_S):
    """(t_grid, lambda(t_grid)) over [0, horizon_s]."""
    n = max(2, int(np.ceil(horizon_s / step_s)) + 1)
    t = np.arange(n, dtype=np.float64) * step_s
    lam = (max(qps, 1e-9)
           * envelope_shape(envelope, t, amplitude, period_h, phase_h)
           * burst.at(t))
    return t, lam


def cumulative_rate(t: np.ndarray, lam: np.ndarray) -> np.ndarray:
    """Trapezoid cumulative integral Lambda(t) with Lambda(0) = 0."""
    out = np.empty_like(t)
    out[0] = 0.0
    np.cumsum(0.5 * (lam[1:] + lam[:-1]) * np.diff(t), out=out[1:])
    return out
