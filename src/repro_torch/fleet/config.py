"""Multi-site fleet deployment description.

A fleet serves one workload from several *sites*: each site is a
continuous-batching deployment (device type, replica count, TP/PP) in
its own grid region, with a named carbon-intensity trace
(``repro_torch.core.datasets.CI_TRACES``) and an optional microgrid (solar
capacity + battery sizing, the paper's Table 1b actors). Requests are
assigned to sites by a pluggable router (``repro_torch.fleet.routing``)
inside the simulation loop, so carbon-aware placement decisions see
each site's live CI signal — not a post-hoc load transform.

Everything here is plain dataclasses over primitives, so a
``FleetConfig`` content-hashes into the sweep cache exactly like a
``SimConfig`` (``repro_torch.sweep.grid.config_digest``).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

from repro_torch.configs.base import ModelConfig
from repro_torch.fleet.autoscale import AutoscalerConfig
from repro_torch.schedule.config import ScheduleConfig
from repro_torch.sim.execmodel import ExecModelConfig
from repro_torch.sim.hybrid import DayConfig
from repro_torch.sim.requests import WorkloadConfig
from repro_torch.sim.scheduler import SchedulerConfig


@dataclasses.dataclass(frozen=True)
class SiteConfig:
    """One datacenter site of the fleet."""
    name: str
    device: str = "a100"              # repro_torch.core.power.DEVICES key
    n_replicas: int = 1
    tp: int = 1
    pp: int = 1
    ci_trace: str = "caiso"           # repro_torch.core.datasets.CI_TRACES key
    # microgrid actors (paper Table 1b); zero capacity disables each
    solar_capacity_w: float = 0.0
    cloudiness: float = 0.12
    solar_seed: int = 3
    battery_capacity_wh: float = 0.0
    soc_init: float = 0.5
    soc_min: float = 0.2
    soc_max: float = 0.8
    scheduler: SchedulerConfig = dataclasses.field(
        default_factory=SchedulerConfig)
    # replica autoscaling (repro_torch.fleet.autoscale); default disabled —
    # the active set is then fixed at n_replicas
    autoscaler: AutoscalerConfig = dataclasses.field(
        default_factory=AutoscalerConfig)

    @property
    def n_devices(self) -> int:
        return self.n_replicas * self.tp * self.pp    # Eq. 2, per site

    @property
    def max_replicas(self) -> int:
        """Replica-list size the runtimes allocate: the autoscaler's
        ceiling when enabled, else the fixed replica count."""
        return (max(self.autoscaler.max_replicas, self.n_replicas)
                if self.autoscaler.enabled else self.n_replicas)


@dataclasses.dataclass
class FleetConfig:
    """The whole deployment: sites + shared workload + router policy."""
    model: ModelConfig
    sites: Tuple[SiteConfig, ...]
    workload: WorkloadConfig = dataclasses.field(
        default_factory=WorkloadConfig)
    router: str = "round_robin"       # repro_torch.fleet.routing.ROUTERS key
    router_params: Dict[str, float] = dataclasses.field(default_factory=dict)
    # temporal admission gate ahead of the router (repro_torch.schedule);
    # default immediate == the gate is a no-op
    schedule: ScheduleConfig = dataclasses.field(
        default_factory=ScheduleConfig)
    execmodel: ExecModelConfig = dataclasses.field(
        default_factory=ExecModelConfig)
    auto_kv_budget: bool = True
    pue: float = 1.2
    resolution_s: float = 60.0        # Eq. 5 bin width for site profiles
    # fixed co-sim horizon (s): pins the idle-energy accounting window
    # so scenarios differing only in admission policy charge identical
    # idle carbon and stay comparable; None = size from the stage logs
    horizon_s: Optional[float] = None
    # day-scale epoch segmentation + fluid/request hybrid evaluation
    # (repro_torch.fleet.day); None = the request-level simulation path
    day: Optional[DayConfig] = None

    def __post_init__(self):
        self.sites = tuple(self.sites)
        if not self.sites:
            raise ValueError("a fleet needs at least one site")
        names = [s.name for s in self.sites]
        if len(set(names)) != len(names):
            raise ValueError(f"site names must be unique, got {names}")

    @property
    def n_devices(self) -> int:
        return sum(s.n_devices for s in self.sites)

    @property
    def device(self) -> str:
        """Joined device mix, for report metadata."""
        return "+".join(dict.fromkeys(s.device for s in self.sites))
