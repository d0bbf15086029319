"""Multi-site heterogeneous fleet simulation with carbon-aware
geo-routing: site/fleet configuration, pluggable routers, and the
``run_fleet_simulation`` entry point that rolls per-site continuous-batching
simulations into a fleet-level energy/carbon/latency report.
"""
from repro_torch.fleet.config import FleetConfig, SiteConfig
from repro_torch.fleet.routing import (ROUTERS, CarbonGreedyFleetRouter,
                                 CarbonSloFleetRouter, FleetRouter,
                                 LeastLoadedFleetRouter,
                                 RoundRobinFleetRouter, RoundRobinRouter,
                                 make_router)
from repro_torch.fleet.simulation import (FleetResult, LoopSite, SiteResult,
                                    drive, run_fleet_simulation)

__all__ = [
    "FleetConfig", "SiteConfig",
    "ROUTERS", "CarbonGreedyFleetRouter", "CarbonSloFleetRouter",
    "FleetRouter", "LeastLoadedFleetRouter", "RoundRobinFleetRouter",
    "RoundRobinRouter", "make_router",
    "FleetResult", "LoopSite", "SiteResult", "drive",
    "run_fleet_simulation",
]
