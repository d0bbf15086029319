"""Scenario sweep engine: declarative grids over SimConfig, parallel
execution with on-disk result memoization, tidy CSV/JSON reporting, and
the paper's experiments as predefined sweeps (``repro_torch.sweep.cli``).

Counterpart of ``repro.sweep``; ``remote`` and ``worker`` are the
shared-filesystem work queue of ``SweepRunner(backend="remote")``.
"""
from repro_torch.sweep.cache import ResultCache, default_cache_root
from repro_torch.sweep.grid import (DEFAULT_GRID_CI, SCHEMA_VERSION,
                                    GridSpec, Scenario, config_digest,
                                    derive_seed, model_registry,
                                    with_overrides)
from repro_torch.sweep.report import (flatten, format_rows, format_table,
                                      to_csv, to_json, write_outputs)
from repro_torch.sweep.remote import (RemoteCoordinator, RemoteOptions,
                                      RemoteStats, pack_shards)
from repro_torch.sweep.runner import (BACKENDS, EXECUTION_MODES,
                                      POSTPROCESSORS, SweepRunner,
                                      SweepStats, execute_scenario,
                                      run_scenarios)
from repro_torch.sweep.scenarios import SWEEPS, SweepDef, run_sweep
from repro_torch.sweep.vectorized import (estimate_group_cost,
                                          estimate_trace_cost,
                                          execute_scenario_group,
                                          group_by_trace)

__all__ = [
    "ResultCache", "default_cache_root",
    "DEFAULT_GRID_CI", "SCHEMA_VERSION", "GridSpec", "Scenario",
    "config_digest", "derive_seed", "model_registry", "with_overrides",
    "flatten", "format_rows", "format_table", "to_csv", "to_json",
    "write_outputs",
    "RemoteCoordinator", "RemoteOptions", "RemoteStats", "pack_shards",
    "BACKENDS", "EXECUTION_MODES", "POSTPROCESSORS", "SweepRunner",
    "SweepStats", "execute_scenario", "run_scenarios",
    "SWEEPS", "SweepDef", "run_sweep",
    "estimate_group_cost", "estimate_trace_cost",
    "execute_scenario_group", "group_by_trace",
]
