"""Carbon-aware scheduling policies (paper Section 5 directions).

Policies transform a load profile given grid signals:
  - ``threshold_deferral``: pause deferrable load when CI > high threshold,
    catch up when CI < low threshold (SPROUT/carbon-aware-batch style)
  - ``solar_following``: scale service capacity with solar availability
  - ``multi_region``: route load to the lower-CI region each step,
    subject to a migration cost

All operate on fixed-resolution numpy arrays so they can prepend the
microgrid scan.
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np


def threshold_deferral(load_w: np.ndarray, ci: np.ndarray,
                       ci_high: float = 200.0, ci_low: float = 100.0,
                       deferrable_frac: float = 0.5,
                       max_backlog_wh: float = 1e9,
                       step_s: float = 60.0) -> Tuple[np.ndarray, Dict]:
    """Defer `deferrable_frac` of load during high-CI steps into a backlog
    served during low-CI steps. Returns (new_load, stats)."""
    dt_h = step_s / 3600.0
    out = np.array(load_w, np.float64)
    backlog = 0.0
    deferred_steps = 0
    catchup_steps = 0
    peak_backlog = 0.0
    for i in range(len(out)):
        if ci[i] > ci_high and backlog < max_backlog_wh:
            d = out[i] * deferrable_frac
            out[i] -= d
            backlog += d * dt_h
            deferred_steps += 1
        elif ci[i] < ci_low and backlog > 0:
            boost = min(backlog / dt_h, out[i] * deferrable_frac + 1e-9)
            out[i] += boost
            backlog -= boost * dt_h
            catchup_steps += 1
        peak_backlog = max(peak_backlog, backlog)
    return out, {"deferred_steps": deferred_steps,
                 "catchup_steps": catchup_steps,
                 "unserved_backlog_wh": backlog,
                 "peak_backlog_wh": peak_backlog}


def solar_following(load_w: np.ndarray, solar_w: np.ndarray,
                    min_frac: float = 0.4) -> np.ndarray:
    """Scale load toward solar availability, never below min_frac (QoS
    floor). Conserves total energy by renormalizing."""
    solar = np.asarray(solar_w, np.float64)
    load = np.asarray(load_w, np.float64)
    cap = np.clip(solar / max(solar.max(), 1e-9), min_frac, 1.0)
    scaled = load * cap
    total_in = load.sum()
    total_out = scaled.sum()
    if total_out > 0:
        scaled = scaled * (total_in / total_out)
    return scaled


def multi_region(load_w: np.ndarray, ci_regions: np.ndarray,
                 migration_penalty_g: float = 5.0,
                 expected_dwell_steps: int = 60,
                 step_s: float = 60.0) -> Tuple[np.ndarray, Dict]:
    """Greedy lowest-CI routing across regions with a per-switch carbon
    penalty amortized over the expected dwell time at the new region.
    ci_regions: (R, T). Returns (assignment (T,), stats)."""
    R, T = ci_regions.shape
    assign = np.zeros(T, np.int32)
    cur = int(np.argmin(ci_regions[:, 0]))
    switches = 0
    dwell_h = expected_dwell_steps * step_s / 3600.0
    for t in range(T):
        best = int(np.argmin(ci_regions[:, t]))
        if best != cur:
            # switch if the CI gap over the expected dwell amortizes the
            # migration penalty
            gap = ci_regions[cur, t] - ci_regions[best, t]
            if gap * load_w[t] / 1000.0 * dwell_h > migration_penalty_g:
                cur = best
                switches += 1
        assign[t] = cur
    ci_eff = ci_regions[assign, np.arange(T)]
    return assign, {"switches": switches,
                    "avg_ci_routed": float(ci_eff.mean()),
                    "avg_ci_region0": float(ci_regions[0].mean())}
