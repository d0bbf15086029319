"""Epoch-granular carbon-aware deferral for day-scale streams.

The request-level admission gate (``apply_admission``) walks a Python
heap per request — fine for thousands of requests, hopeless for a
day's millions. At day scale deferral instead operates on the
``ArrivalStream`` arrays at *epoch* granularity: deferrable arrivals
in a forecast-high-CI epoch shift their release to the start of the
cheapest feasible epoch within their deadline (one forecaster call
per source epoch, argmin over the feasible prefix — all array passes).

Releasing a batch at an epoch boundary concentrates load there by
design: that *deferral drain burst* is exactly one of the transients
the hybrid planner (``repro_torch.sim.hybrid``) must catch, so this module
also returns per-epoch drain counts the planner folds into its
exact/fluid classification.
"""
from __future__ import annotations

from typing import Callable, Dict, Tuple

import numpy as np

from repro_torch.workloads.stream import ArrivalStream


def epoch_deferral(stream: ArrivalStream, bounds: np.ndarray,
                   forecast: Callable, margin: float = 0.02,
                   service_margin_s: float = 120.0
                   ) -> Tuple[np.ndarray, Dict[str, float]]:
    """Shift deferrable releases toward forecast-low-CI epochs.

    Mutates ``stream.ready_s`` in place. A row moves only when the
    cheapest feasible epoch beats its own epoch's forecast CI by more
    than ``margin`` (relative); feasibility requires the target epoch
    start plus ``service_margin_s`` to precede the row's deadline.
    Returns (per-epoch drain counts, admission stats).
    """
    n_ep = len(bounds) - 1
    centers = 0.5 * (bounds[:-1] + bounds[1:])
    drain = np.zeros(n_ep)
    stats = {"n_deferred": 0.0, "deferral_mean_s": 0.0,
             "deferral_max_s": 0.0}
    if not stream.deferrable.any():
        return drain, stats

    arr = stream.arrival_s
    deadline = arr + stream.cfg.deferrable_deadline_s
    epoch_of = np.clip(np.searchsorted(bounds, arr, side="right") - 1,
                       0, n_ep - 1)
    shifts = []
    for e in np.unique(epoch_of[stream.deferrable]):
        rows = np.nonzero(stream.deferrable & (epoch_of == e))[0]
        ci = np.asarray(forecast(float(bounds[e]), centers[e:]),
                        np.float64)
        # prefix argmin: cheapest epoch among offsets [0..j]
        best_idx = np.zeros(len(ci), int)
        cur = 0
        for j in range(len(ci)):
            if ci[j] < ci[cur]:
                cur = j
            best_idx[j] = cur
        # last feasible offset per row (target start + margin <= deadline)
        last = np.searchsorted(bounds, deadline[rows] - service_margin_s,
                               side="right") - 2 - e
        last = np.clip(last, 0, len(ci) - 1)
        tgt = best_idx[last]
        move = (tgt > 0) & (ci[tgt] < ci[0] * (1.0 - margin))
        mrows, mtgt = rows[move], tgt[move]
        stream.ready_s[mrows] = bounds[e + mtgt]
        np.add.at(drain, e + mtgt, 1.0)
        shifts.append(stream.ready_s[mrows] - arr[mrows])

    if shifts:
        all_shifts = np.concatenate(shifts)
        if len(all_shifts):
            stats["n_deferred"] = float(len(all_shifts))
            stats["deferral_mean_s"] = float(all_shifts.mean())
            stats["deferral_max_s"] = float(all_shifts.max())
    return drain, stats
