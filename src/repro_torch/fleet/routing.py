"""Pluggable request routing, at two levels.

**Replica level** — ``RoundRobinRouter`` spreads requests over the
replica schedulers inside one site (extracted from
``repro_torch.sim.scheduler``; the single-site simulator is the trivial
fleet and keeps using it unchanged).

**Site level** — ``FleetRouter`` policies choose which site serves
each arriving request, inside the fleet simulation loop:

  - ``round_robin``: cycle through sites.
  - ``least_loaded``: join-shortest-queue on outstanding tokens.
  - ``carbon_greedy``: geo-route to the lowest-CI site with the
    migration-penalty semantics of ``repro_torch.core.policies.multi_region``
    applied at per-request granularity — the fleet "current" site only
    switches when the CI gap, over the expected dwell at an estimated
    per-request energy, amortizes the migration penalty.
  - ``carbon_slo``: latency-constrained geo-routing — the min-CI site
    whose predicted queue delay (outstanding tokens over an estimated
    service rate) stays under the request's SLO; least-loaded fallback
    when no site qualifies.

Site routers see live site state through a small protocol implemented
by the fleet simulation's site runtimes:

  site.outstanding_tokens() -> int   queued + in-flight token work
  site.outstanding_requests() -> int queued + running request count
  site.ci_at(t_s) -> float           grid CI (gCO2/kWh) at sim time t
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, TYPE_CHECKING

if TYPE_CHECKING:   # avoid import cycle with repro_torch.sim at module load
    from repro_torch.sim.requests import Request
    from repro_torch.sim.scheduler import SchedulerConfig


# --------------------------------------------------------------------------
# replica-level (within one site)
# --------------------------------------------------------------------------

class RoundRobinRouter:
    """Round-robin over a site's replica schedulers."""

    def __init__(self, n_replicas: int, cfg: "SchedulerConfig"):
        from repro_torch.sim.scheduler import ReplicaScheduler
        self.replicas = [ReplicaScheduler(cfg) for _ in range(n_replicas)]
        self._next = 0

    def route(self, req: "Request") -> int:
        """Returns the chosen replica index (the event loop uses it to
        fast-forward idle replicas to the request's arrival)."""
        target = self._next
        self.replicas[target].add(req)
        self._next = (target + 1) % len(self.replicas)
        return target


# --------------------------------------------------------------------------
# site-level (across the fleet)
# --------------------------------------------------------------------------

class FleetRouter:
    """Chooses the site index serving each arriving request."""

    name = "base"

    def choose(self, req: "Request", t_s: float, sites: Sequence) -> int:
        raise NotImplementedError

    def stats(self) -> Dict[str, float]:
        return {}


class RoundRobinFleetRouter(FleetRouter):
    name = "round_robin"

    def __init__(self, n_sites: int):
        self._n = n_sites
        self._next = 0

    def choose(self, req, t_s, sites) -> int:
        i = self._next
        self._next = (self._next + 1) % self._n
        return i


class LeastLoadedFleetRouter(FleetRouter):
    """Join-shortest-queue on outstanding token work (ties: lower index)."""
    name = "least_loaded"

    def __init__(self, n_sites: int):
        self._n = n_sites

    def choose(self, req, t_s, sites) -> int:
        return min(range(self._n),
                   key=lambda i: (sites[i].outstanding_tokens(), i))


class CarbonGreedyFleetRouter(FleetRouter):
    """Greedy lowest-CI geo-routing with sticky migration.

    Per-request analogue of ``policies.multi_region``: the fleet keeps
    a current site and re-routes to the momentary lowest-CI site only
    when the CI gap amortizes ``migration_penalty_g`` over the expected
    dwell —

        (CI_cur - CI_best) * request_kwh_est * dwell_requests
            > migration_penalty_g                          [gCO2]

    ``load_cap_tokens`` (optional) bounds outstanding work per site:
    when the preferred site is saturated, the request overflows to the
    lowest-CI site with room (without committing the sticky choice).
    """
    name = "carbon_greedy"

    def __init__(self, n_sites: int, migration_penalty_g: float = 5.0,
                 request_kwh_est: float = 2e-4,
                 expected_dwell_requests: float = 256.0,
                 load_cap_tokens: Optional[float] = None):
        self._n = n_sites
        self.migration_penalty_g = migration_penalty_g
        self.request_kwh_est = request_kwh_est
        self.expected_dwell_requests = expected_dwell_requests
        self.load_cap_tokens = load_cap_tokens
        self._cur: Optional[int] = None
        self._switches = 0
        self._overflows = 0

    def _has_room(self, site) -> bool:
        return (self.load_cap_tokens is None
                or site.outstanding_tokens() < self.load_cap_tokens)

    def choose(self, req, t_s, sites) -> int:
        ci = [sites[i].ci_at(t_s) for i in range(self._n)]
        best = min(range(self._n), key=lambda i: (ci[i], i))
        if self._cur is None:
            self._cur = best
        elif best != self._cur:
            gap = ci[self._cur] - ci[best]
            amortized = (gap * self.request_kwh_est
                         * self.expected_dwell_requests)
            if amortized > self.migration_penalty_g:
                self._cur = best
                self._switches += 1
        if not self._has_room(sites[self._cur]):
            with_room = [i for i in sorted(range(self._n),
                                           key=lambda i: (ci[i], i))
                         if self._has_room(sites[i])]
            if with_room:
                self._overflows += 1
                return with_room[0]
        return self._cur

    def stats(self) -> Dict[str, float]:
        return {"switches": float(self._switches),
                "overflows": float(self._overflows)}


class CarbonSloFleetRouter(FleetRouter):
    """SLO-bounded carbon routing (the ROADMAP's latency-constrained
    carbon_greedy variant).

    Each site's queue delay is predicted from the O(1) queue-pressure
    counter: ``outstanding_tokens / tokens_per_s`` (a deliberately
    coarse M/D/1-style estimate — the counter is exact, the service
    rate is the knob). Candidates are the sites whose predicted delay
    stays under the request's SLO (``Request.slo_s``, falling back to
    ``default_slo_s`` for untagged/deferrable work); among them the
    lowest-CI site wins. When no site qualifies the router degrades to
    least-loaded — latency first, carbon second.
    """
    name = "carbon_slo"

    def __init__(self, n_sites: int, default_slo_s: float = 30.0,
                 tokens_per_s: float = 4000.0):
        self._n = n_sites
        self.default_slo_s = default_slo_s
        self.tokens_per_s = max(tokens_per_s, 1e-9)
        self._fallbacks = 0

    def _slo(self, req) -> float:
        slo = getattr(req, "slo_s", math.inf) if req is not None \
            else math.inf
        return slo if math.isfinite(slo) else self.default_slo_s

    def choose(self, req, t_s, sites) -> int:
        slo = self._slo(req)
        delays = [sites[i].outstanding_tokens() / self.tokens_per_s
                  for i in range(self._n)]
        ok = [i for i in range(self._n) if delays[i] <= slo]
        if not ok:
            self._fallbacks += 1
            return min(range(self._n),
                       key=lambda i: (sites[i].outstanding_tokens(), i))
        return min(ok, key=lambda i: (sites[i].ci_at(t_s), i))

    def stats(self) -> Dict[str, float]:
        return {"slo_fallbacks": float(self._fallbacks)}


ROUTERS = {
    "round_robin": RoundRobinFleetRouter,
    "least_loaded": LeastLoadedFleetRouter,
    "carbon_greedy": CarbonGreedyFleetRouter,
    "carbon_slo": CarbonSloFleetRouter,
}


def make_router(name: str, n_sites: int, **params) -> FleetRouter:
    if name not in ROUTERS:
        raise KeyError(f"unknown router {name!r}; have {sorted(ROUTERS)}")
    return ROUTERS[name](n_sites, **params)
