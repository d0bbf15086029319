"""Trace-grouped (vectorized) scenario execution.

The expensive part of a scenario is driving the continuous-batching
event loop; everything after it — Eq. 2-3 energy under a PUE, Eq. 4
carbon under a static grid CI, the microgrid post-processors — is a
pure array pass over the logged ``StageTrace``. Grid points whose
*config* is identical (they differ only in the scenario-level ``pue``
/ ``grid_ci`` axes or in ``post.*`` parameters) therefore share one
trace: this module groups them by config digest, runs the simulation
once per group, and evaluates the shared-trace axes stacked —
``stacked_energy_reports`` computes per-stage power once and scales it
across the whole PUE axis, ``emissions_batch`` sweeps the CI axis.

Axes that reach into the config tree (workload, scheduler, device,
TP/PP, exec-model calibration) genuinely diverge the trace — device
and parallelism change stage durations, durations change admission
timing, timing changes batch composition — so each unique config
falls back to one event-loop run. Their *per-stage* roofline still
evaluates through the batched kernel inside the loop.

Fleet scenarios (``FleetConfig``) run their own multi-site rollup and
pass through unchanged.

Both paths assemble records through ``runner.single_site_metrics``,
so vectorized and event-loop records are bit-identical (pinned by
tests/test_torch_sweep.py): the stacked pass evaluates Eq. 1 once per
stage on the group's ``torch_device``, as the event loop's report does.

``repro_torch.sweep.device`` builds on the same grouping: instead of one
numpy pass per group, it pads every group's trace into one batched
tensor set and evaluates the whole grid in a single torch program, with
divergence analysis (``repro_torch.sweep.divergence``) sharing composition
traces across device/TP/PP points where provably safe.

Counterpart of ``repro.sweep.vectorized``.
"""
from __future__ import annotations

import time
from typing import Dict, List, Sequence

from repro_torch.core.carbon import emissions_batch
from repro_torch.core.power import DEVICES, PowerModel
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.fleet.config import FleetConfig
from repro_torch.sweep.grid import Scenario


def estimate_trace_cost(sc: Scenario) -> float:
    """Estimated event-loop stage count for one scenario's trace —
    the scheduling weight for balanced shard/worker packing, not a
    wall-clock prediction. Each request contributes one prefill stage
    plus its decode steps (~avg_len / (1 + pd_ratio) under the
    prefill:decode token-ratio convention); fleet scenarios scale by
    site count (each site drives its own loop over its share)."""
    cfg = sc.cfg
    wl = cfg.workload
    avg_len = 0.5 * (wl.min_len + wl.max_len)
    decode_per_req = avg_len / (1.0 + max(wl.pd_ratio, 1e-9))
    stages = wl.n_requests * (1.0 + decode_per_req)
    if isinstance(cfg, FleetConfig):
        stages *= max(1, len(cfg.sites))
    return max(stages, 1.0)


def estimate_group_cost(scenarios: Sequence[Scenario]) -> float:
    """A trace group's estimated cost: one shared event loop plus a
    small per-scenario stacked-pass/record term. All members share one
    config digest, so the trace estimate comes from the first."""
    return estimate_trace_cost(scenarios[0]) + 0.1 * len(scenarios)


def group_by_trace(scenarios: Sequence[Scenario]) -> List[List[int]]:
    """Order-preserving partition of scenario indices into groups that
    share one simulation trace, keyed by ``Scenario.trace_key`` (the
    config digest alone — everything the event loop's trace depends
    on, nothing the report knobs touch)."""
    groups: Dict[str, List[int]] = {}
    for i, sc in enumerate(scenarios):
        groups.setdefault(sc.trace_key, []).append(i)
    return list(groups.values())


def execute_scenario_group(scenarios: List[Scenario], probe=None,
                           torch_device: DeviceLike = None) -> List[dict]:
    """Execute scenarios that share one config: one event-loop run,
    then stacked metric evaluation per scenario. ``probe``
    (``repro_torch.obs.Probe``) observes the shared simulation and gets the
    rollup under the *first* scenario's PUE/CI (the group shares one
    trace; report knobs differ per scenario). Eq. 1 and the
    post-processors run on ``torch_device`` (``None``: the card)."""
    from repro_torch.core.energy import stacked_energy_reports
    from repro_torch.obs.spans import PROFILER
    from repro_torch.sim import run_simulation
    from repro_torch.sweep.runner import (_execute_fleet_scenario,
                                    shared_result_metrics,
                                    single_site_metrics,
                                    single_site_record)

    torch_device = resolve_device(torch_device)
    if isinstance(scenarios[0].cfg, FleetConfig):
        # the fleet rollup bakes CI signals and PUE into its per-site
        # co-sims — no shared-trace axis to stack; keep the fleet path
        return [_execute_fleet_scenario(sc, probe=probe,
                                        torch_device=torch_device)
                for sc in scenarios]

    t0 = time.perf_counter()
    cfg = scenarios[0].cfg
    if probe is not None:
        probe.on_run_begin(scenarios[0].tag)
    with PROFILER.span("sim.event_loop"):
        res = run_simulation(cfg, probe=probe)
    pm = PowerModel(cfg.device, torch_device=torch_device)
    shared = shared_result_metrics(res)
    sim_elapsed = time.perf_counter() - t0
    with PROFILER.span("stacked_passes"):
        # one array pass over the shared trace covers the whole PUE axis
        reps = stacked_energy_reports(res.stages.mfu, res.stages.dur_s, pm,
                                      n_devices=cfg.n_devices,
                                      pues=[sc.pue for sc in scenarios])
        # ... and one stacked Eq. 4 pass covers the grid-CI axis
        carbons = emissions_batch([r.energy_wh for r in reps],
                                  [r.gpu_hours for r in reps],
                                  DEVICES[cfg.device],
                                  [sc.grid_ci for sc in scenarios])
    if probe is not None:
        # rollup fires after the stacked passes so the caller can hand
        # the probe the group's Eq. 2-3 total (observer-only ordering:
        # records are identical either way)
        probe.on_site_rollup(
            site=0, name=scenarios[0].tag, trace=res.stages,
            device=cfg.device, row_devices=cfg.n_devices,
            pue=scenarios[0].pue, ci=scenarios[0].grid_ci,
            total_devices=cfg.n_devices, energy_wh=reps[0].energy_wh)

    records = []
    with PROFILER.span("record_assembly"):
        for sc, rep, carbon in zip(scenarios, reps, carbons):
            # elapsed_s = the (shared) sim + this record's own
            # evaluation — the scenario's standalone cost, not a
            # cumulative group sum
            rec_t0 = time.perf_counter() - sim_elapsed
            metrics = single_site_metrics(res, sc, rep, carbon=carbon,
                                          shared=shared,
                                          torch_device=torch_device)
            records.append(single_site_record(
                sc, metrics, rec_t0, mode="vectorized",
                trace_scenarios=len(scenarios)))
    return records


def execute_scenario_group_profiled(scenarios: List[Scenario],
                                    torch_device: DeviceLike = None
                                    ) -> tuple:
    """Pool target for profiled fan-out: run the group under the
    worker-local ``PROFILER`` and return ``(records, aggregate)`` so
    the parent can ``merge()`` the per-phase totals (span events
    themselves stay worker-local — cross-process clocks don't share an
    origin)."""
    from repro_torch.obs.spans import PROFILER
    PROFILER.enable(reset=True)
    try:
        records = execute_scenario_group(scenarios,
                                         torch_device=torch_device)
    finally:
        PROFILER.disable()
    return records, PROFILER.aggregate()
