"""Per-workload-class latency/deferral metrics.

Carbon savings from deferral are only meaningful priced against what
each class paid for them: interactive requests in TTFT-vs-SLO terms,
deferrable requests in deferral delay and deadline hits. These columns
ride the fleet summary into the sweep reports (Eq. 5 pipeline -> CSV).

Convention matches ``sim.simulator.latency_stats``: latency is always
measured from *arrival* (the user's clock), so admission parking shows
up as latency paid, never hidden.
"""
from __future__ import annotations

from typing import Dict, Sequence

import numpy as np

from repro_torch.sim.requests import DEFERRABLE, INTERACTIVE, Request


def _pctls(vals, prefix: str) -> Dict[str, float]:
    if not vals:
        return {f"{prefix}_p50_s": -1.0, f"{prefix}_p99_s": -1.0}
    return {f"{prefix}_p50_s": float(np.median(vals)),
            f"{prefix}_p99_s": float(np.percentile(vals, 99))}


def class_stats(requests: Sequence[Request]) -> Dict[str, float]:
    """Tidy per-class columns over a served request set."""
    inter = [r for r in requests if r.klass == INTERACTIVE]
    defer = [r for r in requests if r.klass == DEFERRABLE]
    deferred = [r for r in defer if r.release_s > r.arrival_s]
    delays = [r.release_s - r.arrival_s for r in deferred]

    out: Dict[str, float] = {
        "n_interactive": float(len(inter)),
        "n_deferrable": float(len(defer)),
        "deferred_fraction": len(deferred) / max(len(defer), 1),
        "mean_deferral_delay_s": float(np.mean(delays)) if delays else 0.0,
        "max_deferral_delay_s": float(np.max(delays)) if delays else 0.0,
    }
    out.update(_pctls([r.t_first_token - r.arrival_s for r in inter
                       if r.t_first_token >= 0], "interactive_ttft"))
    out.update(_pctls([r.t_done - r.arrival_s for r in inter
                       if r.t_done >= 0], "interactive_e2e"))
    out.update(_pctls([r.t_done - r.arrival_s for r in defer
                       if r.t_done >= 0], "deferrable_e2e"))
    out["interactive_slo_violations"] = float(sum(
        1 for r in inter
        if r.t_first_token >= 0 and np.isfinite(r.slo_s)
        and r.t_first_token - r.arrival_s > r.slo_s))
    out["deadline_violations"] = float(sum(
        1 for r in defer
        if r.t_done < 0 or r.t_done > r.deadline_s))
    return out
