"""Temporal scheduling configuration attached to a fleet.

``ScheduleConfig`` names an admission policy (``repro_torch.schedule.admission``)
and the carbon-intensity forecaster it consults
(``repro_torch.schedule.forecast``), plus how the per-site CI signals are
combined into the single grid signal the admission gate sees. Plain
dataclass over primitives so it content-hashes into the sweep cache
through ``repro_torch.sweep.grid.config_digest`` like every other config.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

#: valid per-site CI combiners for the admission gate's fleet signal
CI_STATS = ("mean", "min", "max")


@dataclasses.dataclass
class ScheduleConfig:
    """Admission gate ahead of site routing (temporal half; the spatial
    half is the ``FleetRouter``). ``immediate`` + no deferrable class
    reproduces the ungated event loop exactly."""
    policy: str = "immediate"         # repro_torch.schedule.admission.ADMISSIONS
    forecaster: str = "oracle"        # repro_torch.schedule.forecast.FORECASTERS
    policy_params: Dict[str, float] = dataclasses.field(default_factory=dict)
    forecaster_params: Dict[str, float] = dataclasses.field(
        default_factory=dict)
    # how per-site CI signals collapse into the one signal the admission
    # gate forecasts over: "mean" suits spatially-blind routers,
    # "min" suits carbon-aware routers (they will chase the clean site)
    ci_stat: str = "mean"

    def __post_init__(self):
        if self.ci_stat not in CI_STATS:
            raise ValueError(
                f"ci_stat must be one of {CI_STATS}, got {self.ci_stat!r}")
