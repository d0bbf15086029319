"""Temporal carbon-aware scheduling: workload classes, CI forecasting,
and SLO-bounded admission policies operating inside the fleet event
loop (the temporal half of carbon-aware serving; ``repro_torch.fleet.routing``
is the spatial half, and the two compose).
"""
from repro_torch.schedule.admission import (ADMISSIONS, AdmissionPolicy,
                                      ForecastWindowAdmission,
                                      ImmediateAdmission,
                                      ThresholdDeferAdmission,
                                      apply_admission, fleet_ci_forecast,
                                      make_admission)
from repro_torch.schedule.config import CI_STATS, ScheduleConfig
from repro_torch.schedule.forecast import (FORECASTERS, DiurnalTemplateForecaster,
                                     Forecaster, OracleForecaster,
                                     PersistenceForecaster, make_forecaster)
from repro_torch.schedule.metrics import class_stats

__all__ = [
    "ADMISSIONS", "AdmissionPolicy", "ForecastWindowAdmission",
    "ImmediateAdmission", "ThresholdDeferAdmission",
    "apply_admission", "fleet_ci_forecast", "make_admission",
    "CI_STATS", "ScheduleConfig",
    "FORECASTERS", "DiurnalTemplateForecaster", "Forecaster",
    "OracleForecaster", "PersistenceForecaster", "make_forecaster",
    "class_stats",
]
