"""Request-level admission policies: the temporal half of carbon-aware
scheduling.

An admission policy sits *ahead of* site routing inside the fleet event
loop: every arriving request gets a release time >= its arrival, and
the router only sees it at release. Interactive requests are always
released immediately (their TTFT SLO is untouchable); deferrable
requests may be parked toward low-carbon windows, bounded by their
completion deadline and by a finite backlog.

Policies decide *at arrival time* using only the forecasted grid
signal (``repro_torch.schedule.forecast``) — they are causal in the
simulation: the decision for request i depends on information
available at ``arrival_s(i)`` alone, so precomputing releases in
arrival order is equivalent to deciding inside the loop.

  - ``immediate``: release == arrival for every request (the ungated
    event-loop semantics; the no-scheduling baseline).
  - ``threshold_defer``: park deferrable requests while forecast CI is
    above a high threshold, release at the first below-low-threshold
    window before the deadline (SPROUT-style hysteresis). Thresholds
    may be absolute or derived as percentiles of the forecast over the
    request's feasible window.
  - ``forecast_window``: greedy placement — release at the start of
    the cheapest forecast window (mean CI over the estimated service
    duration) that still meets the deadline.
"""
from __future__ import annotations

import heapq
import math
from typing import Callable, Dict, List, Sequence, Type

import numpy as np

from repro_torch.sim.requests import DEFERRABLE, Request

#: forecast callable handed to policies: future times -> predicted CI
ForecastFn = Callable[[np.ndarray], np.ndarray]


class AdmissionPolicy:
    """Decides when an arriving request becomes visible to routing."""

    name = "base"

    def release_time(self, req: Request, t_now_s: float,
                     forecast: ForecastFn, backlog: int) -> float:
        raise NotImplementedError


class ImmediateAdmission(AdmissionPolicy):
    name = "immediate"

    def release_time(self, req, t_now_s, forecast, backlog):
        return t_now_s


def _feasible_grid(t_now_s: float, latest_s: float,
                   step_s: float) -> np.ndarray:
    """Decision grid [t_now, latest] at step_s resolution (always
    contains t_now, so immediate release is always a candidate; never
    overshoots latest — a release past it would eat the service
    margin and blow the deadline)."""
    if latest_s <= t_now_s:
        return np.array([t_now_s])
    return np.arange(t_now_s, latest_s + 1e-9, step_s)


class ThresholdDeferAdmission(AdmissionPolicy):
    """Hysteresis deferral: park while the forecast is high, drain into
    the first low window before the deadline.

    ``ci_high``/``ci_low`` are absolute gCO2/kWh thresholds; left None
    they derive per request as the ``high_pct``/``low_pct`` percentiles
    of the forecast over the feasible window, which adapts the policy
    to any grid's level (hydro vs coal) without retuning. A full
    backlog (``max_backlog`` parked requests) forces immediate
    admission — bounded memory, no starvation pile-up.
    """

    name = "threshold_defer"

    def __init__(self, ci_high: float = None, ci_low: float = None,
                 high_pct: float = 70.0, low_pct: float = 30.0,
                 max_backlog: int = 4096, step_s: float = 300.0,
                 service_margin_s: float = 120.0):
        self.ci_high = ci_high
        self.ci_low = ci_low
        self.high_pct = high_pct
        self.low_pct = low_pct
        self.max_backlog = int(max_backlog)
        self.step_s = float(step_s)
        self.service_margin_s = float(service_margin_s)

    def release_time(self, req, t_now_s, forecast, backlog):
        if req.klass != DEFERRABLE or backlog >= self.max_backlog:
            return t_now_s
        latest = req.deadline_s - self.service_margin_s
        ts = _feasible_grid(t_now_s, latest, self.step_s)
        if len(ts) < 2:
            return t_now_s
        pred = np.asarray(forecast(ts), np.float64)
        hi = self.ci_high if self.ci_high is not None else \
            float(np.percentile(pred, self.high_pct))
        lo = self.ci_low if self.ci_low is not None else \
            float(np.percentile(pred, self.low_pct))
        if pred[0] <= hi:
            return t_now_s
        below = np.nonzero(pred <= lo)[0]
        idx = int(below[0]) if len(below) else int(np.argmin(pred))
        return float(ts[idx])


class ForecastWindowAdmission(AdmissionPolicy):
    """Greedy cheapest-window placement: release each deferrable
    request at the start of the minimum-mean-CI forecast window of
    width ``service_est_s`` that still meets its deadline. Ties (and
    windows not at least ``min_gain_frac`` cheaper than immediate)
    resolve to immediate admission."""

    name = "forecast_window"

    def __init__(self, service_est_s: float = 120.0,
                 step_s: float = 300.0, min_gain_frac: float = 0.0,
                 max_backlog: int = 4096):
        self.service_est_s = float(service_est_s)
        self.step_s = float(step_s)
        self.min_gain_frac = float(min_gain_frac)
        self.max_backlog = int(max_backlog)

    def release_time(self, req, t_now_s, forecast, backlog):
        if req.klass != DEFERRABLE or backlog >= self.max_backlog:
            return t_now_s
        latest = req.deadline_s - self.service_est_s
        ts = _feasible_grid(t_now_s, latest, self.step_s)
        if len(ts) < 2:
            return t_now_s
        # mean forecast CI over the service window starting at each ts
        w = max(1, int(math.ceil(self.service_est_s / self.step_s)))
        pad = ts[-1] + self.step_s * np.arange(1, w)
        pred = np.asarray(forecast(np.concatenate([ts, pad])), np.float64)
        win = np.convolve(pred, np.ones(w) / w, mode="valid")[:len(ts)]
        best = int(np.argmin(win))
        if win[best] >= win[0] * (1.0 - self.min_gain_frac):
            return t_now_s
        return float(ts[best])


ADMISSIONS: Dict[str, Type[AdmissionPolicy]] = {
    "immediate": ImmediateAdmission,
    "threshold_defer": ThresholdDeferAdmission,
    "forecast_window": ForecastWindowAdmission,
}


def make_admission(name: str, **params) -> AdmissionPolicy:
    if name not in ADMISSIONS:
        raise KeyError(
            f"unknown admission policy {name!r}; have {sorted(ADMISSIONS)}")
    return ADMISSIONS[name](**params)


def apply_admission(requests: Sequence[Request], policy: AdmissionPolicy,
                    forecast: Callable[[float, np.ndarray], np.ndarray]
                    ) -> Dict[str, float]:
    """Assign ``release_s`` to every request, in arrival order.

    ``forecast(t_now, ts)`` is the fleet-level CI prediction made at
    decision time ``t_now``. The parked-backlog occupancy seen by each
    decision is the number of earlier requests still awaiting release
    at that arrival (a heap of release times — O(n log n) total).
    Returns gate-side stats for the fleet report; per-request deferral
    delays are reported by ``metrics.class_stats`` (single source) from
    the release times written here.
    """
    parked: List[float] = []
    n_deferred = 0
    backlog_peak = 0
    for req in sorted(requests, key=lambda r: r.arrival_s):
        t = req.arrival_s
        while parked and parked[0] <= t:
            heapq.heappop(parked)
        rel = policy.release_time(
            req, t, lambda ts: forecast(t, np.asarray(ts)), len(parked))
        rel = min(max(rel, t), req.deadline_s)
        if rel > t:
            req.release_s = rel
            heapq.heappush(parked, rel)
            n_deferred += 1
            backlog_peak = max(backlog_peak, len(parked))
    return {
        "n_deferred": float(n_deferred),
        "backlog_peak": float(backlog_peak),
    }


def fleet_ci_forecast(forecaster, signals: Sequence,
                      stat: str = "mean"
                      ) -> Callable[[float, np.ndarray], np.ndarray]:
    """Collapse per-site CI signals into the one forecast the admission
    gate consults (``ScheduleConfig.ci_stat`` picks the combiner)."""
    combine = {"mean": np.mean, "min": np.min, "max": np.max}[stat]

    def fn(t_now_s: float, ts: np.ndarray) -> np.ndarray:
        preds = np.stack([np.asarray(forecaster.predict(sig, t_now_s, ts),
                                     np.float64) for sig in signals])
        return combine(preds, axis=0)

    return fn
